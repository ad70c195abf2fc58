"""Glider ODE-control env in torch: land a falling elliptical plate.

Port of smarties_tpu/envs/glider.py (reference app apps/glider,
glider.h / glider.cpp; the planar gliding model of Paoletti & Mahadevan,
JFM 2011): the plate starts near x = 0, y = 0 and must land at x = 100
on the ground at y = -50.

- dynamics `_deriv` (glider.h:293-321), integrated by the low-storage
  rk46_nl scheme (6 stages) at dt = 5e-3 over 100 substeps per action
  (DT = 0.5); once the state is over (ground contact, x < -50 or
  x > 200) the integration freezes, keeping the substep that crossed;
- start state: u, v ~ U(-0.1, 0.1), w = 0, x ~ U(-10, 10), y = 0,
  a ~ U(-pi, pi);
- step reward: distance gained minus DT; a termination's reward is the
  terminal reward (landing bump minus the final distance) instead, and
  every termination, the step limit included, is a true terminal state.

Observed state: (u, v, w, x, y, cos a, sin a). Action: a torque in
[-1, 1]. Tensor functions over a leading lane axis; start states come
from a torch.Generator or are injected (`u_new` [n, 4] = u, v, x, a).
Each env step runs the derivative 600 times as eager elementwise ops.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from smarties_tpu_torch.core.mdp import MDPSpec

MDP = MDPSpec(dim_state=7, dim_action=1, bounded=(True,),
              upper_action=(1.0,), lower_action=(-1.0,))

MAX_STEPS = 500
DT_SUB = 5e-3            # dt (glider.h:123)
N_SUB = 100              # nstep (glider.h:124)
DT = DT_SUB * N_SUB      # action-step time (0.5)

CT, AA, BB = 1.2, 1.4, 1.0
MUT, NUT, CR = 0.2, 0.2, math.pi
II = 200.0 * 0.1         # RHORATIO * ASPECTRATIO
BETA = 0.1
BETASQ = BETA * BETA
FACT1 = II + BETASQ
FACT2 = II + 1.0
FACT3 = 0.25 * (II * (1 + BETASQ) + 0.5 * (1 - BETASQ) ** 2)

GOAL_X = 100.0
TERM_REW_FAC = 50.0

# Berland-Bogey-Bailly rk46_nl coefficients (glider.h:83-89), used as
# Python floats so that the f32 state stays f32
RK_A = tuple(float(x) for x in np.asarray(
    [0.000000000000, -0.737101392796, -1.634740794341,
     -0.744739003780, -1.469897351522, -2.813971388035]))
RK_B = tuple(float(x) for x in np.asarray(
    [0.032918605146, 0.823256998200, 0.381530948900,
     0.200092213184, 1.718581042715, 0.270000000000]))


class GliderState(NamedTuple):
    q: torch.Tensor      # [V, 6]: u, v, w, x, y, a
    step: torch.Tensor   # [V] i32


def _deriv(q, torque):
    """Diff (glider.h:293-321)."""
    u, v, w, th = q[..., 0], q[..., 1], q[..., 2], q[..., 5]
    eps = 2.2e-16
    uv2p = u * u + v * v
    uv2n = u * u - v * v
    f1 = u * v / (torch.sqrt(uv2p) + eps)
    f2 = uv2n / (uv2p + eps)
    G = (2.0 / math.pi) * (CR * w - CT * f1)
    F = (1.0 / math.pi) * (AA - BB * f2) * torch.sqrt(uv2p)
    M = (MUT + NUT * torch.abs(w)) * w
    sinth, costh = torch.sin(th), torch.cos(th)
    du = (FACT2 * v * w - G * v - sinth - F * u) / FACT1
    dv = (-FACT1 * u * w + G * u - costh - F * v) / FACT2
    dw = ((BETASQ - 1.0) * u * v + torque - M) / FACT3
    dx = u * costh - v * sinth
    dy = u * sinth + v * costh
    return torch.stack([du, dv, dw, dx, dy, w], dim=-1)


def _is_over_space(q):
    """Spatial termination only (glider.h:190-199 without the reference's
    per-substep timeover, which is practically unreachable): the
    mid-step integration freeze. The per-action step limit must not
    freeze the last action's substeps."""
    x, y = q[..., 3], q[..., 4]
    slack = 0.4 * torch.clamp(torch.minimum(x - 50.0, 100.0 - x), min=0.0)
    hit_bottom = y <= -50.0 - slack
    wrong_xdir = x < -50.0
    way_too_far = x > 200.0
    return hit_bottom | wrong_xdir | way_too_far


def _is_over(q, nstep):
    return _is_over_space(q) | (nstep >= MAX_STEPS)


def _draw(gen, n, device):
    """[n, 4] = u, v ~ U(-0.1, 0.1), x ~ U(-10, 10), a ~ U(-pi, pi)."""
    u = torch.empty((n, 4), dtype=torch.float32, device=device)
    u[:, :2].uniform_(-0.1, 0.1, generator=gen)
    u[:, 2].uniform_(-10.0, 10.0, generator=gen)
    u[:, 3].uniform_(-math.pi, math.pi, generator=gen)
    return u


def _start_q(u_new):
    z = torch.zeros_like(u_new[:, 0])
    return torch.stack([u_new[:, 0], u_new[:, 1], z, u_new[:, 2], z,
                        u_new[:, 3]], dim=-1)


def init(gen: Optional[torch.Generator], n: int, device=None,
         u_new: Optional[torch.Tensor] = None) -> GliderState:
    if u_new is None:
        u_new = _draw(gen, n, device)
    return GliderState(q=_start_q(u_new),
                       step=torch.zeros((n,), dtype=torch.int32,
                                        device=u_new.device))


def observe(st: GliderState) -> torch.Tensor:
    q = st.q
    return torch.stack([q[..., 0], q[..., 1], q[..., 2], q[..., 3],
                        q[..., 4], torch.cos(q[..., 5]),
                        torch.sin(q[..., 5])], dim=-1)


def _dist(q):
    """getDistance (glider.h:332-338): |x - 100| only."""
    return torch.abs(q[..., 3] - GOAL_X)


def _terminal_reward(q):
    """getTerminalReward (glider.h:267-292): the landing bump minus the
    final distance."""
    a = torch.remainder(q[..., 5], 2.0 * math.pi)
    dist = _dist(q)
    rela = torch.abs(a - 0.25 * math.pi)
    zero = torch.zeros_like(dist)
    xrew = torch.where(dist > 5.0, zero, torch.exp(-dist * dist))
    arew = torch.where((rela > math.pi / 4) | (dist > 5.0), zero,
                       torch.exp(-10.0 * rela * rela))
    return TERM_REW_FAC * (xrew + arew) - dist


def step(st: GliderState, env_action):
    torque = env_action[..., 0]
    q = st.q
    nstep = st.step + 1
    d_before = _dist(q)
    # rk46_nl over N_SUB substeps with the reference's mid-step stop: a
    # lane frozen before a substep keeps its state, the substep that
    # crosses the boundary is kept, and the lane freezes after it
    frozen = _is_over_space(q)
    for _ in range(N_SUB):
        w = torch.zeros_like(q)
        u = q
        for s in range(6):
            w = w * RK_A[s] + _deriv(u, torque) * DT_SUB
            u = u + w * RK_B[s]
        over = _is_over_space(u)
        q = torch.where(frozen[:, None], q, u)
        frozen = frozen | over
    d_after = _dist(q)
    terminal = _is_over(q, nstep)
    done = terminal
    reward = torch.where(terminal, _terminal_reward(q),
                         (d_before - d_after) - DT)
    return GliderState(q=q, step=nstep), reward, done, terminal


def reset_where(st: GliderState, mask, gen: Optional[torch.Generator] = None,
                u_new: Optional[torch.Tensor] = None) -> GliderState:
    if u_new is None:
        u_new = _draw(gen, st.q.shape[0], st.q.device)
    q = torch.where(mask[:, None], _start_q(u_new), st.q)
    return GliderState(q=q, step=torch.where(mask, torch.zeros_like(st.step),
                                             st.step))

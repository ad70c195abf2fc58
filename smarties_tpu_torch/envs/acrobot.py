"""Vectorized Acrobot (classic control) in torch.

Port of smarties_tpu/envs/acrobot.py (gym's Acrobot-v1, "book"
dynamics): a two-link underactuated pendulum, torque {-1, 0, +1} on the
second joint chosen by the label {0, 1, 2}, reward -1 per step until the
tip rises a link length above the pivot, 500-step limit; one RK4 step of
dt. Tensor functions over a leading env axis; start states come from a
torch.Generator or are injected (`u_new` [n, 4] = th1, th2, w1, w2).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from smarties_tpu_torch.core.mdp import MDPSpec


class AcrobotState(NamedTuple):
    u: torch.Tensor      # [V, 4]: th1, th2, w1, w2
    step: torch.Tensor   # [V] i32


MDP = MDPSpec(dim_state=6, dim_action=1, discrete_values=(3,))

DT = 0.2
MAX_STEPS = 500
M1 = M2 = 1.0
L1 = 1.0
LC1 = LC2 = 0.5
I1 = I2 = 1.0
G = 9.8
MAX_VEL_1 = 4 * math.pi
MAX_VEL_2 = 9 * math.pi


def _dynamics(u, torque):
    th1, th2, w1, w2 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    d1 = (M1 * LC1 ** 2 + M2 * (L1 ** 2 + LC2 ** 2
                                + 2 * L1 * LC2 * torch.cos(th2)) + I1 + I2)
    d2 = M2 * (LC2 ** 2 + L1 * LC2 * torch.cos(th2)) + I2
    phi2 = M2 * LC2 * G * torch.cos(th1 + th2 - math.pi / 2)
    phi1 = (-M2 * L1 * LC2 * w2 ** 2 * torch.sin(th2)
            - 2 * M2 * L1 * LC2 * w2 * w1 * torch.sin(th2)
            + (M1 * LC1 + M2 * L1) * G * torch.cos(th1 - math.pi / 2)
            + phi2)
    a2 = ((torque + d2 / d1 * phi1
           - M2 * L1 * LC2 * w1 ** 2 * torch.sin(th2) - phi2)
          / (M2 * LC2 ** 2 + I2 - d2 ** 2 / d1))
    a1 = -(d2 * a2 + phi1) / d1
    return torch.stack([w1, w2, a1, a2], dim=-1)


def _rk4(u, torque, dt):
    k1 = _dynamics(u, torque)
    k2 = _dynamics(u + dt / 2 * k1, torque)
    k3 = _dynamics(u + dt / 2 * k2, torque)
    k4 = _dynamics(u + dt * k3, torque)
    return u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def _wrap(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def _draw(gen, shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -0.1, 0.1, generator=gen)


def init(gen: Optional[torch.Generator], n_envs: int, device=None,
         u_new: Optional[torch.Tensor] = None) -> AcrobotState:
    if u_new is None:
        u_new = _draw(gen, (n_envs, 4), device)
    return AcrobotState(u=u_new.to(torch.float32),
                        step=torch.zeros((n_envs,), dtype=torch.int32,
                                         device=u_new.device))


def observe(state: AcrobotState) -> torch.Tensor:
    """[cos th1, sin th1, cos th2, sin th2, w1, w2] (gym observation)."""
    u = state.u
    return torch.stack([torch.cos(u[..., 0]), torch.sin(u[..., 0]),
                        torch.cos(u[..., 1]), torch.sin(u[..., 1]),
                        u[..., 2], u[..., 3]], dim=-1)


def step(state: AcrobotState, env_action: torch.Tensor
         ) -> Tuple[AcrobotState, torch.Tensor, torch.Tensor, torch.Tensor]:
    torque = env_action[..., 0].to(torch.float32) - 1.0  # {0,1,2}->{-1,0,1}
    u = _rk4(state.u, torque, DT)
    u = torch.stack([_wrap(u[..., 0]), _wrap(u[..., 1]),
                     torch.clamp(u[..., 2], -MAX_VEL_1, MAX_VEL_1),
                     torch.clamp(u[..., 3], -MAX_VEL_2, MAX_VEL_2)], dim=-1)
    nstep = state.step + 1
    # solved: tip height -cos(th1) - cos(th1 + th2) > 1
    solved = (-torch.cos(u[..., 0]) - torch.cos(u[..., 0] + u[..., 1])) > 1.0
    done = solved | (nstep >= MAX_STEPS)
    reward = torch.where(solved, 0.0, -1.0)
    return AcrobotState(u=u, step=nstep), reward, done, solved


def reset_where(state: AcrobotState, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                u_new: Optional[torch.Tensor] = None) -> AcrobotState:
    if u_new is None:
        u_new = _draw(gen, tuple(state.u.shape), state.u.device)
    u = torch.where(mask[:, None], u_new, state.u)
    stp = torch.where(mask, torch.zeros_like(state.step), state.step)
    return AcrobotState(u=u, step=stp)

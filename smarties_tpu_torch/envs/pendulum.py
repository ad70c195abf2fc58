"""Pendulum swing-up in torch (classic control).

Port of smarties_tpu/envs/pendulum.py (Pendulum-v1 dynamics): state
(theta, theta_dot), observation (cos, sin, theta_dot), bounded torque in
[-2, 2], dense negative-cost reward, 200-step truncation, no terminal
states. Tensor functions over a leading env axis; start states come from
a torch.Generator or are injected (`u_new` [n, 2] = (theta, theta_dot)).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from smarties_tpu_torch.core.mdp import MDPSpec

MDP = MDPSpec(dim_state=3, dim_action=1, bounded=(True,),
              upper_action=(2.0,), lower_action=(-2.0,))

MAX_STEPS = 200
DT = 0.05
G, M, L = 10.0, 1.0, 1.0
MAX_SPEED = 8.0


class PendulumState(NamedTuple):
    th: torch.Tensor      # [V]
    thdot: torch.Tensor   # [V]
    step: torch.Tensor    # [V] i32


def _draw(gen, n, device):
    """[n, 2]: theta ~ U(-pi, pi), theta_dot ~ U(-1, 1)."""
    u = torch.empty((n, 2), dtype=torch.float32, device=device)
    u[:, 0].uniform_(-math.pi, math.pi, generator=gen)
    u[:, 1].uniform_(-1.0, 1.0, generator=gen)
    return u


def init(gen: Optional[torch.Generator], n: int, device=None,
         u_new: Optional[torch.Tensor] = None) -> PendulumState:
    if u_new is None:
        u_new = _draw(gen, n, device)
    return PendulumState(th=u_new[:, 0].clone(), thdot=u_new[:, 1].clone(),
                         step=torch.zeros((n,), dtype=torch.int32,
                                          device=u_new.device))


def observe(st: PendulumState) -> torch.Tensor:
    return torch.stack([torch.cos(st.th), torch.sin(st.th), st.thdot],
                       dim=-1)


def _angle_normalize(x):
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def step(st: PendulumState, env_action):
    u = torch.clamp(env_action[..., 0], -2.0, 2.0)
    th, thdot = st.th, st.thdot
    cost = (_angle_normalize(th) ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2)
    newthdot = thdot + (3 * G / (2 * L) * torch.sin(th)
                        + 3.0 / (M * L ** 2) * u) * DT
    newthdot = torch.clamp(newthdot, -MAX_SPEED, MAX_SPEED)
    newth = th + newthdot * DT
    nstep = st.step + 1
    done = nstep >= MAX_STEPS
    terminal = torch.zeros_like(done)   # a pure time-limit task
    return (PendulumState(th=newth, thdot=newthdot, step=nstep),
            -cost, done, terminal)


def reset_where(st: PendulumState, mask, gen: Optional[torch.Generator] = None,
                u_new: Optional[torch.Tensor] = None) -> PendulumState:
    if u_new is None:
        u_new = _draw(gen, st.th.shape[0], st.th.device)
    return PendulumState(
        th=torch.where(mask, u_new[:, 0], st.th),
        thdot=torch.where(mask, u_new[:, 1], st.thdot),
        step=torch.where(mask, torch.zeros_like(st.step), st.step))

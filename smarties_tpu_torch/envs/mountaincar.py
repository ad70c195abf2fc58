"""Vectorized continuous mountain-car (classic control) in torch.

Port of smarties_tpu/envs/mountaincar.py (gym's
MountainCarContinuous-v0): an underpowered car in a valley, force in
[-1, 1], reward +100 at the right hilltop minus 0.1 action^2 per step,
999-step limit. Tensor functions over a leading env axis; start states
come from a torch.Generator or are injected (`u_new` [n, 2] = position,
velocity).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from smarties_tpu_torch.core.mdp import MDPSpec


class MountainCarState(NamedTuple):
    u: torch.Tensor      # [V, 2]: position, velocity
    step: torch.Tensor   # [V] i32


MDP = MDPSpec(dim_state=2, dim_action=1,
              bounded=(True,), upper_action=(1.0,), lower_action=(-1.0,))

MAX_STEPS = 999
MIN_POS, MAX_POS = -1.2, 0.6
MAX_SPEED = 0.07
GOAL_POS = 0.45
GOAL_VEL = 0.0
POWER = 0.0015


def _draw(gen, n, device):
    """[n, 2]: position ~ U(-0.6, -0.4), velocity 0."""
    pos = torch.empty((n,), dtype=torch.float32, device=device).uniform_(
        -0.6, -0.4, generator=gen)
    return torch.stack([pos, torch.zeros_like(pos)], dim=-1)


def init(gen: Optional[torch.Generator], n_envs: int, device=None,
         u_new: Optional[torch.Tensor] = None) -> MountainCarState:
    if u_new is None:
        u_new = _draw(gen, n_envs, device)
    return MountainCarState(u=u_new.to(torch.float32),
                            step=torch.zeros((n_envs,), dtype=torch.int32,
                                             device=u_new.device))


def observe(state: MountainCarState) -> torch.Tensor:
    return state.u


def step(state: MountainCarState, env_action: torch.Tensor
         ) -> Tuple[MountainCarState, torch.Tensor, torch.Tensor,
                    torch.Tensor]:
    force = torch.clamp(env_action[..., 0], -1.0, 1.0)
    pos, vel = state.u[..., 0], state.u[..., 1]
    vel = vel + force * POWER - 0.0025 * torch.cos(3 * pos)
    vel = torch.clamp(vel, -MAX_SPEED, MAX_SPEED)
    pos = torch.clamp(pos + vel, MIN_POS, MAX_POS)
    vel = torch.where((pos <= MIN_POS) & (vel < 0), 0.0, vel)
    nstep = state.step + 1
    solved = (pos >= GOAL_POS) & (vel >= GOAL_VEL)
    done = solved | (nstep >= MAX_STEPS)
    reward = torch.where(solved, 100.0, 0.0) - 0.1 * force * force
    u = torch.stack([pos, vel], dim=-1)
    return MountainCarState(u=u, step=nstep), reward, done, solved


def reset_where(state: MountainCarState, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                u_new: Optional[torch.Tensor] = None) -> MountainCarState:
    if u_new is None:
        u_new = _draw(gen, state.step.shape[0], state.u.device)
    u = torch.where(mask[:, None], u_new, state.u)
    stp = torch.where(mask, torch.zeros_like(state.step), state.step)
    return MountainCarState(u=u, step=stp)

"""Predator-prey: two agents per env on a periodic 2-D arena, in torch.

Port of smarties_tpu/envs/predator_prey.py (the reference's competing
multi-agent demo, apps/predator_prey): the predator is rewarded by
closing the distance to the prey, the prey by opening it; both observe
both positions; actions are bounded 2-D velocities, the predator slightly
slower. Episodes truncate at MAX_STEPS, so every episode of an env ends
at the same step.

Lanes are env-major, V = n_envs * 2: [env0-predator, env0-prey,
env1-predator, ...]. Start positions come from a torch.Generator or are
injected (`u_new` [n_envs, 4] = predator x, y, prey x, y).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from smarties_tpu_torch.core.mdp import MDPSpec

N_AGENTS = 2
ARENA = 1.0          # periodic box [0, 1)^2
SPEED_PRED = 0.01    # predator max step
SPEED_PREY = 0.012   # prey slightly faster
MAX_STEPS = 200

MDP = MDPSpec(dim_state=4, dim_action=2,
              bounded=(True, True), upper_action=(1.0, 1.0),
              lower_action=(-1.0, -1.0), n_agents_per_env=N_AGENTS)


class PPState(NamedTuple):
    pred: torch.Tensor   # [E, 2] predator positions
    prey: torch.Tensor   # [E, 2]
    step: torch.Tensor   # [E] i32


def _n_envs(n_lanes: int) -> int:
    assert n_lanes % N_AGENTS == 0
    return n_lanes // N_AGENTS


def _draw(gen, n_envs, device):
    """[n_envs, 4]: both positions ~ U[0, 1)^2."""
    return torch.rand((n_envs, 4), generator=gen, device=device)


def init(gen: Optional[torch.Generator], n_lanes: int, device=None,
         u_new: Optional[torch.Tensor] = None) -> PPState:
    E = _n_envs(n_lanes)
    if u_new is None:
        u_new = _draw(gen, E, device)
    return PPState(pred=u_new[:, :2].clone(), prey=u_new[:, 2:].clone(),
                   step=torch.zeros((E,), dtype=torch.int32,
                                    device=u_new.device))


def _rel(a, b):
    """Shortest periodic displacement b - a (round half to even, as
    jnp.round)."""
    d = b - a
    return d - torch.round(d)


def observe(st: PPState) -> torch.Tensor:
    """Per-lane obs [V, 4]: [own x, own y, rel dx, rel dy] (periodic)."""
    rel_pp = _rel(st.pred, st.prey)
    obs_pred = torch.cat([st.pred, rel_pp], dim=-1)
    obs_prey = torch.cat([st.prey, -rel_pp], dim=-1)
    return torch.stack([obs_pred, obs_prey], dim=1).reshape(-1, 4)


def step(st: PPState, env_action: torch.Tensor):
    E = st.pred.shape[0]
    act = env_action.reshape(E, N_AGENTS, 2)
    pred = torch.remainder(st.pred + SPEED_PRED * act[:, 0], ARENA)
    prey = torch.remainder(st.prey + SPEED_PREY * act[:, 1], ARENA)
    dist = torch.linalg.vector_norm(_rel(pred, prey), dim=-1)
    reward = torch.stack([-dist, dist], dim=1).reshape(-1)
    nstep = st.step + 1
    done = torch.repeat_interleave(nstep >= MAX_STEPS, N_AGENTS)
    terminal = torch.zeros_like(done)   # always a truncation
    return PPState(pred=pred, prey=prey, step=nstep), reward, done, terminal


def reset_where(st: PPState, mask_lanes: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                u_new: Optional[torch.Tensor] = None) -> PPState:
    """Re-draw both positions of every env with any masked lane."""
    mask = mask_lanes.reshape(-1, N_AGENTS).any(dim=1)
    if u_new is None:
        u_new = _draw(gen, st.pred.shape[0], st.pred.device)
    return PPState(
        pred=torch.where(mask[:, None], u_new[:, :2], st.pred),
        prey=torch.where(mask[:, None], u_new[:, 2:], st.prey),
        step=torch.where(mask, torch.zeros_like(st.step), st.step))

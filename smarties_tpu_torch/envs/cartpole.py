"""Vectorized cart-pole in torch — the framework's canonical test env.

Port of smarties_tpu/envs/cartpole.py (reference demo app
apps/cart_pole_py/exec.py:14-90): pole balancing with the angle itself
hidden (cos/sin observed), bounded 1-D force in [-10, 10], reward
1 - failed, episodes truncated at 500 steps; RK4 with 4 substeps of dt/4.

Every function is a tensor function over a leading env axis [n_envs, 4].
Initial conditions come from an explicit torch.Generator, or are injected
(`u_new`) so tests can hand both frameworks the same draws. `discrete` is
the two-label variant, `pomdp` the one with the velocities hidden.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from smarties_tpu_torch.core.mdp import MDPSpec


class CartPoleState(NamedTuple):
    u: torch.Tensor      # [V, 4]: x, v, angle, omega
    step: torch.Tensor   # [V] i32


MDP = MDPSpec(
    dim_state=6, dim_action=1,
    bounded=(True,), upper_action=(10.0,), lower_action=(-10.0,),
    observable=(True, True, False, True, True, True),
)

DT = 0.02
MAX_STEPS = 500


def _dynamics(u, force):
    """apps/cart_pole_py/exec.py:40-55 (non-swingup branch)."""
    mp, mc, ell, g = 0.1, 1.0, 0.5, 9.81
    v, a, w = u[..., 1], u[..., 2], u[..., 3]
    cosy, siny = torch.cos(a), torch.sin(a)
    tot = mp + mc
    fac2 = ell * (4.0 / 3.0 - mp * cosy * cosy / tot)
    f1 = force + mp * ell * w * w * siny
    wdot = (g * siny - f1 * cosy / tot) / fac2
    vdot = (f1 - mp * ell * wdot * cosy) / tot
    return torch.stack([v, vdot, w, wdot], dim=-1)


def _rk4(u, force, dt):
    k1 = _dynamics(u, force)
    k2 = _dynamics(u + dt / 2 * k1, force)
    k3 = _dynamics(u + dt / 2 * k2, force)
    k4 = _dynamics(u + dt * k3, force)
    return u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)


def _uniform_u(gen, shape, device):
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -0.05, 0.05, generator=gen)


def init(gen: Optional[torch.Generator], n_envs: int, device=None,
         u_new: Optional[torch.Tensor] = None) -> CartPoleState:
    """Initial states U(-0.05, 0.05) from `gen`, or `u_new` [n_envs, 4]."""
    if u_new is None:
        u_new = _uniform_u(gen, (n_envs, 4), device)
    return CartPoleState(u=u_new.to(torch.float32),
                         step=torch.zeros((n_envs,), dtype=torch.int32,
                                          device=u_new.device))


def observe(state: CartPoleState) -> torch.Tensor:
    """[x, v, angle, omega, cos, sin] (exec.py:65-70)."""
    u = state.u
    return torch.cat([u, torch.cos(u[..., 2:3]), torch.sin(u[..., 2:3])],
                     dim=-1)


def _failed(u):
    return (torch.abs(u[..., 0]) > 2.4) | (torch.abs(u[..., 2])
                                           > math.pi / 15)


def step(state: CartPoleState, env_action: torch.Tensor
         ) -> Tuple[CartPoleState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Advance one control step -> (new_state, reward [V], done [V] bool,
    terminal [V] bool): `terminal` is a true failure (sendTermState), done
    without terminal a time-limit truncation (sendLastState),
    exec.py:96-113."""
    force = env_action[..., 0]
    u = state.u
    for _ in range(4):
        u = _rk4(u, force, DT / 4)
    nstep = state.step + 1
    failed = _failed(u)
    done = (nstep >= MAX_STEPS) | failed
    truncated = (nstep >= MAX_STEPS) & (~failed)
    terminal = done & (~truncated)
    reward = 1.0 - failed.to(torch.float32)
    return CartPoleState(u=u, step=nstep), reward, done, terminal


def reset_where(state: CartPoleState, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                u_new: Optional[torch.Tensor] = None) -> CartPoleState:
    """Re-draw initial conditions for masked lanes (exec.py:23-27): from
    `gen` (one draw per lane, used where masked) or the injected `u_new`."""
    if u_new is None:
        u_new = _uniform_u(gen, tuple(state.u.shape), state.u.device)
    u = torch.where(mask[:, None], u_new, state.u)
    stp = torch.where(mask, torch.zeros_like(state.step), state.step)
    return CartPoleState(u=u, step=stp)


class pomdp:
    """No-velocity cart-pole (smarties_tpu/envs/cartpole.py:105-122): only
    [x, cos(angle), sin(angle)] are observable, the partially observed
    task the RACER_RNN recipe targets (README.rst:352): a feed-forward
    net cannot infer the velocities, a recurrent one must carry them."""

    MDP = MDPSpec(dim_state=6, dim_action=1, bounded=(True,),
                  upper_action=(10.0,), lower_action=(-10.0,),
                  observable=(True, False, False, False, True, True))
    MAX_STEPS = MAX_STEPS

    init = staticmethod(init)
    observe = staticmethod(observe)
    reset_where = staticmethod(reset_where)
    step = staticmethod(step)


class discrete:
    """Discrete-action variant: force in {-10, +10} selected by the label
    (smarties_tpu/envs/cartpole.py:125-142), the bang-bang cart-pole of
    the discrete learners (RACER-discrete, DQN)."""

    MDP = MDPSpec(dim_state=6, dim_action=1, discrete_values=(2,),
                  observable=(True, True, False, True, True, True))
    MAX_STEPS = MAX_STEPS

    init = staticmethod(init)
    observe = staticmethod(observe)
    reset_where = staticmethod(reset_where)

    @staticmethod
    def step(state, env_action):
        """label {0, 1} -> force {-10, 10}."""
        force = (env_action[..., 0] * 2.0 - 1.0) * 10.0
        return step(state, force[..., None])

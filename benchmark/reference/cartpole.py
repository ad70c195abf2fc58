"""Cart-pole's dynamics, after the numpy app of cselab/smarties
apps/cart_pole_py/exec.py (RK4 with 4 substeps of dt / 4): a pole on a
cart, force in [-10, 10] N, failure at |x| > 2.4 or |angle| > pi / 15,
episodes cut at 500 steps; the state [x, v, angle, omega, cos(angle),
sin(angle)], the angle itself hidden from the learner."""
from __future__ import annotations

import numpy as np

DT = 0.02
MAX_STEPS = 500
OBSERVED = [0, 1, 3, 4, 5]


def _f(u, F):
    mp, mc, ell, g = 0.1, 1.0, 0.5, 9.81
    x, v, a, w = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    cosy, siny = np.cos(a), np.sin(a)
    tot = mp + mc
    fac2 = ell * (4.0 / 3.0 - mp * cosy * cosy / tot)
    f1 = F + mp * ell * w * w * siny
    wdot = (g * siny - f1 * cosy / tot) / fac2
    vdot = (f1 - mp * ell * wdot * cosy) / tot
    return np.stack([v, vdot, w, wdot], axis=-1)


def advance(u, F):
    """One control step of states u [..., 4] under forces F [...]."""
    dt = DT / 4
    F = np.asarray(F, np.float64)
    for _ in range(4):
        k1 = _f(u, F)
        k2 = _f(u + dt / 2 * k1, F)
        k3 = _f(u + dt / 2 * k2, F)
        k4 = _f(u + dt * k3, F)
        u = u + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4)
    return u


def failed(u):
    return (np.abs(u[..., 0]) > 2.4) | (np.abs(u[..., 2]) > np.pi / 15)


def full_state(u):
    return np.concatenate([u, np.cos(u[..., 2:3]), np.sin(u[..., 2:3])], -1)


def transition_gaps(states, actions, rewards, length, terminal,
                    action_scale=10.0):
    """Hold stored episodes of the observed state [x, v, omega, cos, sin]
    to the dynamics: each stored next state, reward and end against one
    step from the stored state (the angle recovered as atan2(sin, cos))
    under the stored learner action squashed to the force scale *
    tanh(a). -> (largest state gap, wrong rewards or ends).
    states [E, L1, 5], actions [E, L1, 1], rewards [E, L1], float64."""
    worst, wrong = 0.0, 0
    for e in range(states.shape[0]):
        T = int(length[e])
        s = states[e, :T + 1]
        u = np.stack([s[:, 0], s[:, 1], np.arctan2(s[:, 4], s[:, 3]),
                      s[:, 2]], -1)
        u1 = advance(u[:T], action_scale * np.tanh(actions[e, :T, 0]))
        obs1 = full_state(u1)[:, OBSERVED]
        worst = max(worst, float(np.max(np.abs(obs1 - s[1:]))))
        fail = failed(u1)
        wrong += int(np.sum((1.0 - fail) != rewards[e, 1:T + 1]))
        over = fail | (np.arange(1, T + 1) >= MAX_STEPS)
        wrong += int(np.sum(over[:-1])) + int(not over[-1])
        wrong += int(bool(terminal[e]) != bool(fail[-1]))
    return worst, wrong

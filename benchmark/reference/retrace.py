"""Retrace targets of one stored episode, in float64 NumPy (Munos et
al. 2016; cselab/smarties ReplayMemory/MemoryProcessing.cpp):

  Qret[t] = r~[t+1] + gamma (V[t+1] + lambda min(1, rho[t+1])
                               (Qret[t+1] - A[t+1] - V[t+1]))   t < T
  Qret[T] = 0 for a terminal episode, V[T] for a truncated one,

with r~ = (r - reward mean) / reward std and rows past T zero.
"""
from __future__ import annotations

import numpy as np


def retrace_rows(r, v, adv, rho, length, terminal, rew_mean, rew_scale,
                 gamma, lam):
    """Qret [E, L1] for rows r, v (V[T] already in place), adv, rho of
    shape [E, L1] (float64), length [E], terminal [E]."""
    E, L1 = r.shape
    q = np.zeros((E, L1))
    rs = (r - rew_mean) * rew_scale
    for e in range(E):
        T = int(length[e])
        nxt = 0.0 if terminal[e] else v[e, T]
        q[e, T] = nxt
        for t in range(T - 1, -1, -1):
            c = min(1.0, rho[e, t + 1])
            nxt = rs[e, t + 1] + gamma * (
                v[e, t + 1] + lam * c * (nxt - adv[e, t + 1] - v[e, t + 1]))
            q[e, t] = nxt
    return q

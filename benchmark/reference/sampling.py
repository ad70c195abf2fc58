"""Rank-based prioritized sampling (Schaul et al. 2016, "Prioritized
Experience Replay"; cselab/smarties ReplayMemory/Sampling.cpp,
TSample_impRank), in float64 NumPy: every stored step i gets p_i
proportional to 1 / rank_i, its rank by |TD error| among the stored
steps in descending order (ties in the order of the flat index
slot * L1 + t), and a draw for a uniform u in [0, 1) is the step whose
cumulative-probability interval holds u."""
from __future__ import annotations

import numpy as np


def per_rank_cdf(err_abs, valid):
    """Cumulative probabilities [n] over the flat steps; err_abs, valid
    flat [n] (slot-major)."""
    key = np.where(valid, err_abs, -1.0)
    order = np.argsort(-key, kind="stable")
    rank = np.empty(key.size)
    rank[order] = np.arange(1, key.size + 1)
    p = np.where(valid, 1.0 / rank, 0.0)
    return np.cumsum(p / p.sum())


def draw_gaps(cdf, flat, u):
    """How far each u lies outside the interval [cdf[i-1], cdf[i]) of the
    drawn step i (0 inside it), in units of the total probability."""
    lo = np.where(flat > 0, cdf[np.maximum(flat - 1, 0)], 0.0)
    hi = cdf[flat]
    return np.maximum(np.maximum(lo - u, u - hi), 0.0)

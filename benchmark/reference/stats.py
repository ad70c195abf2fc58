"""The replay's exact state and reward statistics (smarties
MemoryProcessing::updateRewardsStats at training start): the mean and
standard deviation, per state dimension, of every stored state (t = 0..T
of every stored episode), and of every stored reward (t = 1..T); a
variance is floored at float32's epsilon."""
from __future__ import annotations

import torch

F32_EPS = 1.1920928955078125e-07


def moments(states_tm, rewards_tm, slot_len, slot_id, block: int = 2048):
    """{state_mean, state_std, rew_mean, rew_std} in float64, from the
    time-major replay [L1, E, D]; uint8 states are summed exactly in
    int64, float states in float64, `block` slots at a time."""
    L1, E, D = states_tm.shape
    dev = states_tm.device
    t = torch.arange(L1, device=dev)[:, None]
    valid = slot_id[None, :] >= 0
    smask = (t <= slot_len[None, :]) & valid
    exact = not states_tm.dtype.is_floating_point
    acc = torch.int64 if exact else torch.float64
    s1 = torch.zeros(D, dtype=acc, device=dev)
    s2 = torch.zeros(D, dtype=acc, device=dev)
    for e0 in range(0, E, block):
        for r in range(L1):
            m = smask[r, e0:e0 + block]
            if not bool(m.any()):
                continue
            x = states_tm[r, e0:e0 + block][m].to(acc)
            s1 += x.sum(0)
            s2 += (x * x).sum(0)
    n = float(smask.sum())
    mean = s1.double() / n
    var = torch.clamp(s2.double() / n - mean * mean, min=F32_EPS)
    rmask = (t >= 1) & (t <= slot_len[None, :]) & valid
    r = rewards_tm.double()[rmask]
    rvar = torch.clamp(torch.mean(r * r) - torch.mean(r) ** 2, min=F32_EPS)
    return {"state_mean": mean, "state_std": torch.sqrt(var),
            "rew_mean": torch.mean(r), "rew_std": torch.sqrt(rvar)}

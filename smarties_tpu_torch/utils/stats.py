"""Replay and training statistics: the console table and the
importance-weight histogram.

Port of smarties_tpu/utils/stats.py (reference: the stats table printed
every 1000 grad steps, MemoryBuffer::getMetrics, MemoryBuffer.cpp:522-575
and Learner::processStats, Learner.cpp:158-195, columns in
README.rst:375-388; the off-policy importance-weight histogram,
MemoryProcessing::histogramImportanceWeights,
MemoryProcessing.cpp:353-389).

Each statistic is one masked reduction over the time-major replay on the
device, stacked into one tensor (`replay_metrics_device`); the host reads
it once, in `replay_metrics`, which the Trainer calls only from
log_status(full=True). The histogram counts on the device too and reads
its bin counts once.
"""
from __future__ import annotations

import numpy as np
import torch

from smarties_tpu_torch.replay import buffer as rb

METRIC_KEYS = ("nEp", "nObs", "totEp", "totObs", "avgR", "stdr", "DKL",
               "RMSE", "avgQ", "minQ", "maxQ", "nFarP", "beta", "alpha",
               "maxAbsE")


def replay_metrics_device(rs: rb.ReplayState) -> torch.Tensor:
    """[len(METRIC_KEYS)] f32 on the replay's device: exact whole-buffer
    statistics over the valid steps t < T of the valid slots."""
    f32 = torch.float32
    mask = rs.valid_steps_tm()                          # [L1, E]
    maskf = mask.to(f32)
    n = torch.clamp(torch.sum(maskf), min=1.0)
    far = rb.is_far_policy(rs.rho_tm, rs.cmax_ret, rs.cinv_ret) & mask
    # t < T only: the stored value field needs no v_trunc substitution
    q = rs.value_tm + rs.advantage_tm
    valid_eps = rs.valid_slots()
    tot_r_per_ep = torch.sum(rs.rewards_tm * maskf, dim=0)
    n_eps = torch.clamp(torch.sum(valid_eps.to(f32)), min=1.0)
    inf = torch.full((), float("inf"), dtype=f32, device=q.device)
    out = [
        torch.sum(valid_eps.to(f32)),
        rs.n_stored_steps().to(f32),
        rs.n_seen_eps.to(f32),
        rs.n_seen_steps.to(f32),
        torch.sum(torch.where(valid_eps, tot_r_per_ep,
                              torch.zeros_like(tot_r_per_ep))) / n_eps,
        rs.rew_std,
        torch.sum(rs.kl_tm * maskf) / n,
        torch.sqrt(torch.sum(rs.delta_tm * rs.delta_tm * maskf) / n),
        torch.sum(q * maskf) / n,
        torch.min(torch.where(mask, q, inf)),
        torch.max(torch.where(mask, q, -inf)),
        torch.sum(far.to(f32)),
        rs.beta, rs.alpha, rs.max_abs_error,
    ]
    return torch.stack([x.to(f32).reshape(()) for x in out])


def replay_metrics(rs: rb.ReplayState) -> dict:
    """The statistics as host floats (one read of the device)."""
    vals = replay_metrics_device(rs).cpu().numpy()
    return {k: float(v) for k, v in zip(METRIC_KEYS, vals)}


def stats_header() -> str:
    """Column header of the reference's console table
    (README.rst:375-388)."""
    return ("|  nEp |   nObs |  totEp |  totObs | oldEp |nFarP "
            "| avgR | stdr | DKL | RMSE | avgQ | minQ | maxQ | beta")


def stats_row(rs: rb.ReplayState, grad_step: int) -> str:
    m = replay_metrics(rs)
    return (f"{grad_step:>7d} {m['nEp']:>6.0f} {m['nObs']:>8.0f} "
            f"{m['totEp']:>7.0f} {m['totObs']:>8.0f} {m['nFarP']:>6.0f} "
            f"{m['avgR']:>8.2f} {m['stdr']:>6.2f} {m['DKL']:>7.4f} "
            f"{m['RMSE']:>6.3f} {m['avgQ']:>7.2f} {m['minQ']:>7.2f} "
            f"{m['maxQ']:>7.2f} {m['beta']:>5.3f}")


def _iw_bounds(n_bins: int) -> np.ndarray:
    """Bin edges: 0, n_bins - 1 log-spaced edges in [1e-3, 50], f32 max."""
    beg, end = np.log(1e-3), np.log(50.0)
    return np.concatenate([
        [0.0], np.exp(beg + (end - beg) * (np.arange(1, n_bins) - 1.0)
                      / (n_bins - 2.0)), [np.finfo(np.float32).max]])


def iw_histogram(rs: rb.ReplayState, n_bins: int = 81) -> str:
    """Importance-weight histogram printout
    (histogramImportanceWeights, MemoryProcessing.cpp:353-389):
    log-spaced bins in [1e-3, 50], fraction of the dataset per bin.
    Binned as numpy.histogram bins (right edge open but the last's),
    in f64 on the device."""
    bounds = _iw_bounds(n_bins)
    rho = rs.rho_tm.to(torch.float64)
    edges = torch.as_tensor(bounds, dtype=torch.float64, device=rho.device)
    idx = torch.bucketize(rho, edges, right=True) - 1
    idx = torch.where(rho == edges[-1], n_bins - 1, idx)
    # bin n_bins: the invalid steps; n_bins + 1: a weight outside the
    # edges (none is, but for a NaN), counted in the size only
    idx = torch.where((idx < 0) | (idx >= n_bins), n_bins + 1, idx)
    idx = torch.where(rs.valid_steps_tm(), idx, n_bins)
    counts = torch.bincount(idx.reshape(-1), minlength=n_bins + 2
                            ).cpu().numpy()
    size = int(counts.sum() - counts[n_bins])
    if size == 0:
        return "(empty replay)"
    frac = counts[:n_bins] / size
    hmean = 2 * bounds[:-1] * bounds[1:] / np.maximum(
        bounds[:-1] + bounds[1:], 1e-12)
    lines = ["OFF-POLICY IMP WEIGHTS HISTOGRAM (bin harmonic mean: frac)"]
    row = "  ".join(f"{h:.3g}:{f:.3f}" for h, f in zip(hmean, frac)
                    if f > 0)
    lines.append(row)
    return "\n".join(lines)

"""Frozen yardsticks: the card's published peaks, the FLOPs of a grad
step, the bytes K1 must move, spreads and percentiles.

Copied from the port where it had them (runtime/profile_main.step_flops,
runtime/bench_retrace.moved_bytes and HBM_BYTES_PER_S, bench.FP32_PEAKS)
so that a later change to the program cannot move the benchmark's
measure; the originals are listed in PERF.md for deletion.
"""
from __future__ import annotations

import math
import statistics

# Published dense peaks by the name torch.cuda.get_device_name gives
# (NVIDIA's H100 SXM data sheet): FP32 outside the tensor cores, TF32 and
# bf16 tensor-core rates, HBM bandwidth. They assume the 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32": 67e12, "tf32": 495e12,
                              "bf16": 989e12, "hbm": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def dense_macs(conv, sizes) -> list:
    """Multiply-adds per input row of each layer: conv layers as
    (in_w, in_h, in_c, out_c, filter, stride) with valid padding, then the
    dense layers between consecutive `sizes`."""
    macs = []
    for in_w, in_h, in_c, out_c, filt, stride in conv:
        out_w = (in_w - filt) // stride + 1
        out_h = (in_h - filt) // stride + 1
        macs.append(out_h * out_w * out_c * filt * filt * in_c)
    macs += [a * b for a, b in zip(sizes[:-1], sizes[1:])]
    return macs


def step_flops(conv, sizes, n_forward: int, n_backward: int) -> int:
    """FLOPs (2 per multiply-add) of one grad step of a feed-forward net
    with a conv stack: the forward over n_forward rows, and for
    n_backward of them the weight gradient of every layer and the input
    gradient of every layer but the first. Activations, biases and the
    optimiser are left out (runtime/profile_main.step_flops)."""
    macs = dense_macs(conv, sizes)
    return 2 * (n_forward * sum(macs)
                + n_backward * (2 * sum(macs) - macs[0]))


def k1_sweep_bytes(mode: str, L1: int, lens, select,
                   zero_unselected: bool) -> int:
    """Bytes K1's replay sweep (retrace_sweep_) must move: per computed
    slot of length T, F fields (4 for Retrace, 2 for GAE) at t = 1..T,
    its length (4 B), terminal flag (1 B) and v_trunc (4 B); every
    written row has L1 f32 elements; the select flag per slot and the two
    reward scalars (runtime/bench_retrace.moved_bytes, entry
    "retrace_sweep"). lens, select: numpy arrays over the slots."""
    n_fields = 2 if mode == "GAE" else 4
    n_sel = int(select.sum())
    rows = lens.size if zero_unselected else n_sel
    return ((n_fields * int(lens[select].sum()) + rows * L1) * 4
            + 9 * n_sel + lens.size + 8)


def spread(values) -> float:
    """Distance between the first and third quartile over the median
    (statistics.quantiles, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def percentile(values, q: float) -> float:
    """The q-th percentile by the nearest-rank rule over all values."""
    xs = sorted(values)
    k = max(1, math.ceil(q / 100 * len(xs)))
    return xs[k - 1]


def union_length(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, start: float, end: float):
    """The gaps of [start, end] that no interval covers, as (s, e)."""
    gaps, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        gaps.append((t, end))
    return [(s, e) for s, e in gaps if e > s]

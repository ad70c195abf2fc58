"""Reading a torch.profiler trace of the device: kernel intervals by
name, the device's busy time (their union), the largest device
operations and the longest idle gaps, each labelled by the kernel the
card waited for (the next one to start)."""
from __future__ import annotations

import bisect
from collections import defaultdict

from benchmark import yardstick


def profile(fn):
    """Run fn() under torch.profiler -> the reading of its device
    kernels, see `read`. Only the device's activity is traced. On a
    captured path the trace slows the host below the card's pace all the
    same (a traced cycle of vracer_cartpole.fused took 1.10-1.69 s
    against 0.83 s untraced on an NVIDIA H100 80GB HBM3; 1.41 s with the
    host's operations recorded as well)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return read(prof.events())


def read(events):
    """{"kernels": [(name, start_us, end_us)], "window": (first kernel's
    start, last kernel's end)} from profiler events."""
    import torch
    kernels = [(e.name, e.time_range.start, e.time_range.end)
               for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    window = ((min(k[1] for k in kernels), max(k[2] for k in kernels))
              if kernels else None)
    return {"kernels": kernels, "window": window}


def busy_us(tr) -> float:
    s, e = tr["window"]
    return yardstick.union_length(
        (max(a, s), min(b, e)) for _, a, b in tr["kernels"] if b > s and a < e)


def window_us(tr) -> float:
    s, e = tr["window"]
    return e - s


def breakdown(tr, n: int = 10) -> dict:
    """The n device operations with the most time, and the n longest
    idle gaps labelled by the kernel that ended each ("end" for the
    window's tail), as [name, seconds]."""
    by_name = defaultdict(float)
    for name, a, b in tr["kernels"]:
        by_name[name] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    s, e = tr["window"]
    gaps = yardstick.idle_gaps([(a, b) for _, a, b in tr["kernels"]], s, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
    starts = sorted((a, name) for name, a, _ in tr["kernels"])
    nxt = [a for a, _ in starts]

    def label(t):
        i = bisect.bisect_left(nxt, t)
        return "before " + starts[i][1][:100] if i < len(nxt) else "end"

    return {"device_ops": [[k[:120], v / 1e6] for k, v in ops],
            "idle_gaps": [[label(b), (b - a) / 1e6] for a, b in gaps]}

"""Driver of the fused mix with the traced step's phases (mix
fused_phases): train_fused's set-up, window, CUPTI cycle and checks, as
they are (its Setup, K1Bytes and check), and then, on --trace 1, the
phases of the captured grad step.

After the CUPTI cycle the profiler traces (Trainer.profiler.trace(): a
second step graph that stamps each phase's end on the card's timer,
ops/stamp.py), runs the mix's warm_s of cycles (capturing that graph
brings the card's slow mode back, PERF.md section 7), resets, runs the
mix's phase_cycles cycles and keeps Profiler.summary() as ctx["phases"]:
the median ms of each stamped phase of a replay (a conv stack's
conv_forward and conv_backward among them), which train.step_conv_ms and
train.conv_roofline read. The window, which the end-to-end metrics time,
replays the plain step graph.

The program must stamp a conv stack's phases (algos/vracer.py
CONV_STEP_PHASES); a program without them cannot run the cell, and the
run stops before its set-up.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from benchmark import conv_flops
from benchmark import trace as btrace
from benchmark import yardstick
from benchmark.drivers import program, train_fused
from benchmark.harness import RunError


def _require_conv_phases():
    try:
        from smarties_tpu_torch.algos.vracer import CONV_STEP_PHASES
    except ImportError:
        raise RunError("the program stamps no conv phases in its traced "
                       "grad step (algos/vracer.py CONV_STEP_PHASES): it "
                       "cannot run this mix") from None
    return CONV_STEP_PHASES


def _cycles(tr, warm_s: float = 0.0, n: int = 0):
    """Fused cycles for warm_s seconds of the host's clock, or n of
    them."""
    h, done = time.perf_counter(), 0
    while (time.perf_counter() - h < warm_s) if warm_s else done < n:
        tr.train_fused(tr.n_envs, log_every=10 ** 12, flush=False)
        done += 1


def run(files, ref, seed, seconds, trace, options, t_start) -> dict:
    _require_conv_phases()
    mix = files["mix"]
    s = train_fused.Setup(files, ref, seed, options)
    tr, dev = s.tr, s.dev
    # untimed cycles: a process's captured steps run slower for its first
    # seconds on the card (PERF.md, section 7)
    warm_s = options.get("warm_s", mix.get("warm_s", 0))
    _cycles(tr, warm_s)
    setup_s = time.perf_counter() - t_start - s.excluded
    cuda = dev.type == "cuda"
    tr.profiler.reset()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # the tests' CPU runs pass an event that reads the host's clock
    event = options.get("event", torch.cuda.Event)
    e0, e1 = (event(enable_timing=True) for _ in range(2))
    e0.record()
    h0 = time.perf_counter()
    cycles = 0
    while cycles == 0 or time.perf_counter() - h0 < seconds:
        tr.train_fused(tr.n_envs, log_every=10 ** 12, flush=False)
        cycles += 1
    e1.record()
    e1.synchronize()
    window_s = e0.elapsed_time(e1) / 1e3
    grad_steps = cycles * s.n_train
    tr.profiler.table()
    spans = {k: (tr.profiler.totals[k], tr.profiler.counts[k])
             for k in tr.profiler.totals}
    print(f"window: {cycles} cycles, {window_s!r} s, spans "
          f"{ {k: [round(v, 6), n] for k, (v, n) in spans.items()} }",
          file=sys.stderr)
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    device = {"platform": "gpu" if cuda else "cpu", "kind": name,
              "count": 1,
              "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if cuda else 0)}
    conv = s.arch.get("conv", [])
    sizes = [s.arch["n_in"]] + list(s.arch["hidden"]) + [s.arch["n_out"]]
    B = tr.cfg.batchSize
    ctx = {"spans": spans, "grad_steps": grad_steps, "window_s": window_s,
           # [s_t; s_t1] go forward together, and back
           "flops_per_step": yardstick.step_flops(conv, sizes, 2 * B, 2 * B),
           "conv_flops_per_step": conv_flops.step_conv_flops(conv, 2 * B),
           "peaks": yardstick.peaks(name)}
    out = {"end_to_end": {"grad_steps_per_s": grad_steps / window_s,
                          "setup_s": setup_s},
           "attempted": grad_steps, "failed": 0, "device": device}
    if trace and cuda:
        k1 = train_fused.K1Bytes(tr, tr.algo.returns_mode)
        reading = btrace.profile(
            lambda: tr.train_fused(tr.n_envs, log_every=10 ** 12,
                                   flush=False))
        ctx["trace"] = reading
        ctx["k1_bytes"] = k1.total()
        device["busy_s"] = btrace.busy_us(reading) / 1e6
        device["window_s"] = btrace.window_us(reading) / 1e6
        out["breakdown"] = btrace.breakdown(reading)
    if trace:
        tr.profiler.trace()
        _cycles(tr, warm_s)
        tr.profiler.reset()
        _cycles(tr, n=mix.get("phase_cycles", 4))
        ctx["phases"] = tr.profiler.summary()
        print(f"phases: {ctx['phases']}", file=sys.stderr)
    snap, arch = s.snap, s.arch
    del s, tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["numbers"] = train_fused.check(
        snap, ref, arch, program.settings(files, options.get("sizes")))
    out["ctx"] = ctx
    return out

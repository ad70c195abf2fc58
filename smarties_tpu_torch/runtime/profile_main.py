"""Where the time of the main path goes, on one CUDA card.

    python3 -m smarties_tpu_torch.runtime.profile_main

Builds the V-RACER cart-pole trainer at the width of chip_smoke.py's
main path (1024 envs x 4096 slots x 501 steps, [128, 128] net, batch 256;
the JAX package's bench.py::_build_trainer configuration), warms it up,
runs one fused cycle, and then times each part of a cycle alone:

- per part, ms per call three ways: CUDA events around the call, the
  host's enqueue time (perf_counter before the device is synchronised)
  and the host's total time. Enqueue equal to the event time means the
  card waits for the host;
- under torch.profiler, for a train step and an env sweep: the profiled
  wall time per call, the device's busy time per call (the summed
  durations of its kernels, which run on one stream and do not
  overlap), the busy share of the profiled wall, and the CUDA kernel
  launches and device kernels per call.

Needs a CUDA card (exits 2 without one). Imports no JAX.
"""
from __future__ import annotations

import subprocess
import sys
import time

import torch

from smarties_tpu_torch.algos.base import presample_uniform
from smarties_tpu_torch.envs import cartpole
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters


def main_path_trainer() -> Trainer:
    cfg = HyperParameters(minTotObsNum=16384, maxTotObsNum=262144,
                          batchSize=256, obsPerStep=1.0,
                          nnLayerSizes=[128, 128], randSeed=0)
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=1024, n_slots=4096,
                 max_len=cartpole.MAX_STEPS, device="cuda")
    tr.log_flush_threshold = 10 ** 9
    return tr


def time_calls(fn, n: int):
    """(events, host enqueue, host total) ms per call over n calls."""
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    h1 = time.perf_counter()
    e1.synchronize()
    h2 = time.perf_counter()
    return (e0.elapsed_time(e1) / n, (h1 - h0) * 1e3 / n,
            (h2 - h0) * 1e3 / n)


def profile_calls(fn, n: int):
    """torch.profiler over n calls -> dict of per-call figures."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        h0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - h0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    launches = sum(1 for e in prof.events()
                   if e.name.startswith("cudaLaunchKernel"))
    return {"wall_ms": wall_ms / n, "busy_ms": busy_ms / n,
            "busy_share": busy_ms / wall_ms, "launches": launches / n,
            "device_kernels": len(kernels) / n}


def main():
    if not torch.cuda.is_available():
        print("profile_main: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    tr = main_path_trainer()
    tr.warmup(chunk=16, blind_sweeps=16)
    tr.train_fused(tr.n_envs, log_every=10 ** 9, flush=False)

    eps, ts = presample_uniform(tr.gen_batch, tr.replay, tr.cfg.batchSize,
                                1)

    def roll():
        tr.carry, _ = tr._rollout(tr.params, tr.carry, 1)

    def ingest():
        tr.carry = tr.carry._replace(replay=tr._fix_returns(tr.replay))

    def refresh():
        tr.carry = tr.carry._replace(
            replay=tr._refresh(tr.replay, float(tr.n_grad_steps)))

    def train_step():
        tr.params, tr.opt_state, rs, _ = tr.algo.train_step(
            tr.params, tr.opt_state, tr.replay,
            sample_override=(eps[0], ts[0]))
        tr.carry = tr.carry._replace(replay=rs)

    parts = (
        ("env sweep (1024 envs)", roll, 10),
        ("ingest sweep (refresh_new_returns)", ingest, 20),
        ("train chunk of 100 steps", lambda: tr._train_chunk(100), 3),
        ("refresh", refresh, 20),
        ("train_step", train_step, 50),
        ("evaluate 32 episodes x 100 steps",
         lambda: tr.evaluate(32, 100, materialize=False), 3),
    )
    for name, fn, n in parts:
        fn()
        ev, enq, tot = time_calls(fn, n)
        print(f"{name}: {ev:.3f} ms/call (events) | host enqueue "
              f"{enq:.3f} ms/call | host total {tot:.3f} ms/call (n={n})",
              flush=True)
    for name, fn, n in (("train_step", train_step, 20),
                        ("env sweep", roll, 5)):
        p = profile_calls(fn, n)
        print(f"profile {name}: wall {p['wall_ms']:.3f} ms/call (profiled) "
              f"| device busy {p['busy_ms']:.3f} ms/call | busy share "
              f"{p['busy_share']:.4f} | kernel launches/call "
              f"{p['launches']:.1f} | device kernels/call "
              f"{p['device_kernels']:.1f} (n={n})", flush=True)


if __name__ == "__main__":
    main()

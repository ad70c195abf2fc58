#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (smarties_tpu_torch).

    python3 chip_smoke.py      # every phase, one CUDA card

Phases, each reported on its own line:
1. device: a CUDA card is required (exit 2 without one; there is no CPU
   fallback). Prints `nvidia-smi --query-gpu=name,power.limit` and turns
   TF32 off for matmuls and cuDNN.
2. kernels: builds K1 (csrc/retrace.cu) with nvcc from this checkout and
   holds both entry points against their plain torch versions on the
   card at [200, 37], [33, 22] and the main path's [4096, 501], in the
   time-major layout the replay stores and in row-major, for Retrace and
   GAE. Times kernel and plain version at [4096, 501] with CUDA events,
   and turns the kernel's time into the bandwidth of the bytes it moves.
3. reference: the port on the card against the port on the CPU at a
   small size, from one state (8 train steps and a refresh, so K1 runs
   inside the pipeline against its plain version).
4. main path: the V-RACER cart-pole trainer at full width (1024 envs x
   4096 slots x 501 steps, [128, 128] net, batch 256): warmup, two fused
   cycles (2048 grad steps, two 1000-step refreshes), one train() chunk
   and evaluate(32). Checks finiteness, the stored-step count, and that
   K1 was launched at each of its four sites.
5. learners: RACER, RACER-discrete, DQN, NAF, DPG and MixedPG, each
   through the launcher (smarties_tpu_torch.launch.run) at its recipe's
   published widths and batch with 1024 envs: warmup, train(1000) timed
   with CUDA events (so the 1000-step refresh runs), evaluate(8, 200).
   Checks finiteness and K1's launches at ingest, initialize_stats and
   refresh on every Retrace path (DQN's recipe has no Retrace sweep: its
   0 is measured and printed); then the port on the card against the port
   on the CPU at a small size (4 pinned train steps and a refresh).
Then one JSON line with the kernels' results and, last, the device line.

The script imports no JAX and nothing of the JAX package. Any failed
check raises and the exit code is non-zero.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# agreement of kernel and plain version, as tests/test_pallas_retrace.py
RTOL = 1e-4
ATOL = 1e-4
KERNEL_SHAPES = ((200, 37), (33, 22), (4096, 501))
MAIN_E, MAIN_L1 = 4096, 501
# the learners phase: (name, app, recipe as the launcher takes it)
LEARNER_PATHS = (
    ("racer", "cartpole", "RACER"),
    ("racer_discrete", "cartpole_discrete", "RACER"),
    ("dqn", "cartpole_discrete", "DQN"),
    ("naf", "pendulum", "NAF"),
    ("dpg", "pendulum", "DPG"),
    ("mixedpg", "cartpole", '{"learner": "MixedPG"}'),
)
LEARNER_ENVS, LEARNER_STEPS = 1024, 1000


def phase_device():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script runs on a CUDA card only", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    print(f"device: {torch.cuda.get_device_name(0)} | count "
          f"{torch.cuda.device_count()} | torch {torch.__version__} | "
          f"cuda {torch.version.cuda} | tf32 off", flush=True)
    return card


def _event_ms(fn, n, flush=None):
    """Median ms of `fn` over n timed launches after 3 warm-up calls;
    `flush` runs before each launch, outside the timed region."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        if flush is not None:
            flush()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _retrace_inputs(rng, E, L1, time_major, dev):
    import numpy as np
    import torch

    def f32(x):
        t = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        return t.t().contiguous().t() if time_major else t.contiguous()

    r = f32(rng.randn(E, L1))
    v = f32(rng.randn(E, L1))
    adv = f32(rng.randn(E, L1))
    rho = f32(np.exp(rng.randn(E, L1)))
    b = f32(rng.rand(E, L1) * 0.9)
    lens = torch.as_tensor(rng.randint(1, L1, E).astype(np.int32),
                           device=dev)
    terms = torch.as_tensor(rng.rand(E) > 0.5, device=dev)
    return r, v, adv, rho, b, lens, terms


def phase_kernels():
    import numpy as np
    import torch
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.ops import returns as ret

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rk.library()
    build_s = time.perf_counter() - t0
    nvcc_s = rk.build_info["seconds"]
    print(f"kernels: K1 built in {build_s:.2f} s (nvcc "
          f"{'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'}) -> "
          f"{os.path.relpath(rk.build_info['path'])}", flush=True)
    for line in rk.build_info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    rng = np.random.RandomState(0)
    err = {"affine_suffix_scan": 0.0, "batched_retrace": 0.0}

    def check(name, got, want, what):
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name} {what}: {m}")
        e = float((got - want).abs().max()) if got.numel() else 0.0
        err[name] = max(err[name], e)
        print(f"  {name} {what}: max|kernel - plain| = {e:.3e}", flush=True)

    for E, L1 in KERNEL_SHAPES:
        for tm in (True, False):
            lay = "time-major" if tm else "row-major"
            r, v, adv, rho, b, lens, terms = _retrace_inputs(rng, E, L1,
                                                             tm, dev)
            check("affine_suffix_scan", rk.affine_suffix_scan(r, b),
                  ret.affine_suffix_scan_plain(r, b), f"[{E},{L1}] {lay}")
            for mode in ("retrace", "GAE"):
                args = (r, v, adv, rho, lens, terms, 0.995, 0.95, mode)
                check("batched_retrace", rk.batched_retrace(*args),
                      ret.batched_retrace_plain(*args),
                      f"[{E},{L1}] {lay} {mode}")

    # times at the main path's shape and layout; the 64 MB scratch write
    # evicts the 33 MB of inputs from the 50 MB L2, as at a refresh
    r, v, adv, rho, b, lens, terms = _retrace_inputs(rng, MAIN_E, MAIN_L1,
                                                     True, dev)
    scratch = torch.empty(16 * 2 ** 20, device=dev)
    flush = scratch.zero_
    args = (r, v, adv, rho, lens, terms, 0.995, 0.95, "retrace")
    times = {
        "batched_retrace": (
            _event_ms(lambda: rk.batched_retrace(*args), 50, flush),
            _event_ms(lambda: ret.batched_retrace_plain(*args), 20, flush)),
        "affine_suffix_scan": (
            _event_ms(lambda: rk.affine_suffix_scan(r, b), 50, flush),
            _event_ms(lambda: ret.affine_suffix_scan_plain(r, b), 20,
                      flush)),
    }
    # bytes each kernel moves: batched_retrace reads r, V, A and rho at
    # t = 1..length only (V[length] is the bootstrap), plus length and
    # terminal, and writes all L1 steps; affine_suffix_scan reads a and b
    # and writes q over all L1 steps
    moved = {
        "batched_retrace": (4 * int(lens.sum()) + MAIN_E * MAIN_L1) * 4
                           + 5 * MAIN_E,
        "affine_suffix_scan": 3 * MAIN_E * MAIN_L1 * 4,
    }
    gbps = {}
    for name, (k_ms, p_ms) in times.items():
        gbps[name] = moved[name] / (k_ms * 1e-3) / 1e9
        print(f"kernels: {name} [{MAIN_E},{MAIN_L1}] time-major, cold L2: "
              f"kernel {k_ms:.4f} ms | plain {p_ms:.4f} ms (median) | "
              f"{moved[name]} B moved, {gbps[name]:.1f} GB/s", flush=True)
    return {"build_s": build_s, "err": err, "times": times, "gbps": gbps}


class SiteCounter:
    """Attributes K1 launches to their sites by diffing the launch counter
    around the trainer's three return-sweep callables. The ingest sweep
    counts under `ingest_site`, which the main path sets per phase."""

    def __init__(self, trainer, rk):
        self.rk = rk
        self.ingest_site = "ingest"
        self.sites = {}
        for attr, site in (("_fix_returns", "ingest"),
                           ("_init_stats", "initialize_stats"),
                           ("_refresh", "refresh")):
            setattr(trainer, attr, self._wrap(getattr(trainer, attr), site))

    def _wrap(self, fn, site):
        def counted(*a, **kw):
            n0 = self.rk.launches["batched_retrace"]
            out = fn(*a, **kw)
            key = self.ingest_site if site == "ingest" else site
            self.sites[key] = (self.sites.get(key, 0)
                               + self.rk.launches["batched_retrace"] - n0)
            return out
        return counted


def _leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix.rstrip("."), tree)]


def _card_vs_cpu(env, cfg, n_steps):
    """The port on the card against the port on the CPU (whose K1 is the
    plain torch loop) at a small size, from the same state: the CPU
    trainer's warmup, then its params, optimiser state and replay copied
    to the card, n_steps train steps on the same pinned samples and a
    refresh on both. cuBLAS and the CPU BLAS reduce in another order (TF32
    off): rtol 1e-4; values pass through scale_net2v in RACER, which
    cancels two terms near 5100 (one f32 ulp is 4.9e-4): atol 2e-3 on V,
    TD errors and returns. Returns the worst |diff| of params, qret, rho
    and value."""
    import numpy as np
    import torch
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.runtime.trainer import Trainer

    size = dict(n_envs=16, n_slots=64, max_len=64)
    cpu = Trainer(env, env.MDP, cfg, device="cpu", **size)
    cpu.warmup(chunk=16)
    gpu = Trainer(env, env.MDP, cfg, device="cuda", **size)
    gpu.params = convert.params_from_jax(convert.params_to_jax(cpu.params),
                                         "cuda")
    gpu.opt_state = convert.opt_state_from_jax(
        convert.opt_state_to_numpy(cpu.opt_state), "cuda")
    gpu.carry = gpu.carry._replace(replay=convert.replay_from_jax(
        convert.replay_to_numpy(cpu.replay), "cuda"))
    rng = np.random.RandomState(0)
    lens = convert.replay_to_numpy(cpu.replay)["length"]
    valid = np.nonzero(convert.replay_to_numpy(cpu.replay)["ep_id"] >= 0)[0]
    for _ in range(n_steps):
        pairs = set()
        while len(pairs) < cfg.batchSize:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, lens[e]))))
        ep, t = (torch.tensor(x, dtype=torch.int32) for x in zip(*pairs))
        for tr in (cpu, gpu):
            tr.params, tr.opt_state, _, _ = tr.algo.train_step(
                tr.params, tr.opt_state, tr.replay,
                sample_override=(ep.to(tr.device), t.to(tr.device)))
    for tr in (cpu, gpu):
        tr.carry = tr.carry._replace(replay=tr._refresh(tr.replay, 1000.0))
    worst = {"params": 0.0}
    got_p = dict(_leaves(gpu.params))
    for k, p in _leaves(cpu.params):
        g = got_p[k].detach().cpu()
        torch.testing.assert_close(g, p.detach(), rtol=1e-4, atol=1e-6,
                                   msg=lambda m: f"param {k}: {m}")
        worst["params"] = max(worst["params"],
                              float((g - p.detach()).abs().max()))
    want = convert.replay_to_numpy(cpu.replay)
    got = convert.replay_to_numpy(gpu.replay)
    for k in convert.REPLAY_FIELDS:
        atol = 2e-3 if k in ("qret", "delta", "value", "v_trunc",
                             "max_abs_error") else 1e-5
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=atol,
                                   err_msg=f"replay field {k}")
        if k in ("qret", "rho", "value"):
            worst[k] = float(np.abs(got[k] - want[k]).max())
    return worst


def phase_reference():
    """V-RACER on cart-pole, 8 pinned train steps and a refresh."""
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.utils.config import HyperParameters

    cfg = HyperParameters(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
                          nnLayerSizes=[16, 16], randSeed=0)
    worst = _card_vs_cpu(cartpole, cfg, 8)
    print(f"reference: port on the card vs on the CPU, 16 envs x 64 slots, "
          f"8 train steps + refresh: max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()), flush=True)


def phase_main_path():
    import numpy as np
    import torch
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters

    cfg = HyperParameters(minTotObsNum=16384, maxTotObsNum=262144,
                          batchSize=256, obsPerStep=1.0,
                          nnLayerSizes=[128, 128], randSeed=0)
    t_build = time.perf_counter()
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=1024, n_slots=4096,
                 max_len=cartpole.MAX_STEPS, device="cuda")
    tr.log_flush_threshold = 10 ** 9
    assert tr.replay.rewards.shape == (MAIN_E, MAIN_L1)
    sites = SiteCounter(tr, rk)
    torch.cuda.synchronize()
    print(f"main: trainer built in {time.perf_counter() - t_build:.2f} s "
          f"(1024 envs, 4096 x 501 slots, [128,128], batch 256)",
          flush=True)

    rk.reset_launches()
    sites.ingest_site = "warmup_train_ingest"
    t0 = time.perf_counter()
    tr.warmup(chunk=16, blind_sweeps=16)
    torch.cuda.synchronize()
    print(f"main: warmup (16 blind sweeps + initialize_stats) "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    sites.ingest_site = "fused_cycle_ingest"
    cycle_ms = []
    for _ in range(2):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        tr.train_fused(tr.n_envs, log_every=10 ** 9, flush=False)
        e1.record()
        e1.synchronize()
        cycle_ms.append(e0.elapsed_time(e1))
    sites.ingest_site = "warmup_train_ingest"
    g0 = tr.n_grad_steps
    t0 = time.perf_counter()
    tr.train(100, log_every=10 ** 9)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rets = tr.evaluate(32)
    eval_s = time.perf_counter() - t0
    counts = dict(rk.launches)
    site_counts = dict(sites.sites)

    # checks
    for k, p in _leaves(tr.params):
        assert torch.isfinite(p).all(), f"non-finite parameter {k}"
    for k, m in tr._last_metrics.items():
        assert torch.isfinite(m).all(), f"non-finite metric {k}"
    assert np.isfinite(rets).all() and rets.shape == (32,), rets
    n_stored = int(tr.replay.n_stored_steps())
    assert n_stored > 0, n_stored
    assert tr.n_grad_steps - g0 >= 100 and g0 >= 2048, (g0, tr.n_grad_steps)
    for site in ("warmup_train_ingest", "initialize_stats", "refresh",
                 "fused_cycle_ingest"):
        assert site_counts.get(site, 0) > 0, \
            f"K1 was not launched at the {site} site: {site_counts}"
    assert counts["batched_retrace"] == sum(site_counts.values()), \
        (counts, site_counts)

    per_cycle = statistics.median(cycle_ms)
    print(f"main: fused cycle {cycle_ms[0]:.1f} / {cycle_ms[1]:.1f} ms "
          f"(1 env sweep + 1024 grad steps) | "
          f"{1024 / per_cycle * 1e3:.1f} grad steps/s | "
          f"{tr.n_envs / per_cycle * 1e3:.1f} env steps/s", flush=True)
    print(f"main: train() chunk of {tr.n_grad_steps - g0} steps "
          f"{train_s:.2f} s | evaluate(32) {eval_s:.2f} s, mean return "
          f"{float(np.mean(rets)):.2f} | stored steps {n_stored} | "
          f"grad steps {tr.n_grad_steps} | env steps {tr.n_env_steps}",
          flush=True)
    print(f"main: K1 launches {counts} by site {site_counts}", flush=True)
    return {"cycle_ms": cycle_ms, "launches": counts, "sites": site_counts}


def _small_cfg(recipe):
    """The launcher's recipe cut to the reference phase's small size."""
    from smarties_tpu_torch import launch
    cfg = launch.load_recipe(recipe, 0)
    cfg.minTotObsNum, cfg.maxTotObsNum, cfg.batchSize = 256, 2048, 32
    cfg.nnLayerSizes = [16, 16]
    if any(s > 0 for s in cfg.encoderLayerSizes):
        cfg.encoderLayerSizes = [16]
    return cfg


def phase_learners():
    """The six other learners through the launcher, each at its recipe's
    widths: K1 counted per site around warmup + train(1000), the grad
    step timed with CUDA events, then evaluate and the small-size
    reference against the CPU."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.ops import retrace_kernel as rk

    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    results = {}
    for name, app, recipe in LEARNER_PATHS:
        args = launch.parse_args([
            app, "--recipe", recipe, "--device", "cuda", "--nEnvironments",
            str(LEARNER_ENVS), "--nTrainSteps", str(LEARNER_STEPS),
            "--runprefix", runs, "--runname", name])
        hooks = {}

        def prepare(tr):
            tr.log_flush_threshold = 10 ** 9
            hooks["sites"] = SiteCounter(tr, rk)
            train = tr.train

            def timed_train(n, **kw):
                g0 = tr.n_grad_steps
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                e0.record()
                train(n, **kw)
                e1.record()
                e1.synchronize()
                hooks.update(train_ms=e0.elapsed_time(e1),
                             train_wall_s=time.perf_counter() - t0,
                             steps=tr.n_grad_steps - g0)
            tr.train = timed_train

        rk.reset_launches()
        t0 = time.perf_counter()
        tr = launch.run(args, prepare=prepare)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts, sites = dict(rk.launches), dict(hooks["sites"].sites)
        rets = tr.evaluate(8, max_steps=200)

        for k, p in _leaves(tr.params):
            assert torch.isfinite(p).all(), f"{name}: non-finite param {k}"
        for k, m in tr._last_metrics.items():
            assert torch.isfinite(m).all(), f"{name}: non-finite metric {k}"
        assert np.isfinite(rets).all() and rets.shape == (8,), (name, rets)
        assert hooks["steps"] >= LEARNER_STEPS, (name, hooks)
        assert counts["batched_retrace"] == sum(sites.values()), \
            (name, counts, sites)
        mode = tr.algo.returns_mode
        if mode == "none":
            assert counts["batched_retrace"] == 0, (name, counts)
            k1 = ("K1 launches 0, measured: returnsEstimator 'none' "
                  "(1-step targets) runs no Retrace sweep")
        else:
            for site in ("ingest", "initialize_stats", "refresh"):
                assert sites.get(site, 0) > 0, \
                    f"{name}: K1 was not launched at the {site} site: {sites}"
            k1 = f"K1 launches by site {sites}"
        worst = _card_vs_cpu(launch.env_module(app), _small_cfg(recipe), 4)
        shutil.rmtree(tr.run_dir)
        cfg = tr.cfg
        widths = (f"enc {cfg.encoderLayerSizes} + {cfg.nnLayerSizes}"
                  if type(tr.algo).__name__ == "DPG" else
                  f"{cfg.nnLayerSizes}")
        ms_step = hooks["train_ms"] / hooks["steps"]
        print(f"learners: {name} ({type(tr.algo).__name__}, {app}, "
              f"{widths}, batch {cfg.batchSize}, {LEARNER_ENVS} envs, "
              f"returns {mode}): train({LEARNER_STEPS}) "
              f"{hooks['train_ms']:.1f} ms by events "
              f"({ms_step:.3f} ms/grad step, host wall "
              f"{hooks['train_wall_s']:.2f} s) | launch.run {run_s:.2f} s | "
              f"evaluate(8, 200) mean return {float(np.mean(rets)):.2f} | "
              f"{k1} | card vs CPU max |diff| "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()),
              flush=True)
        results[name] = {"sites": sites, "launches": counts["batched_retrace"],
                         "ms_per_grad_step": ms_step,
                         "train_ms": hooks["train_ms"], "run_s": run_s,
                         "card_vs_cpu": worst}
    return results


def main():
    phase_device()
    import torch
    kern = phase_kernels()
    phase_reference()
    main_res = phase_main_path()
    learners = phase_learners()
    launches = main_res["launches"]
    k_ms, p_ms = kern["times"]["batched_retrace"]
    a_ms, ap_ms = kern["times"]["affine_suffix_scan"]
    print(json.dumps({"kernels": [{
        "name": "retrace_suffix_scan",
        "route": "cuda",
        "source": "smarties_tpu_torch/csrc/retrace.cu",
        "replaces": "smarties_tpu/ops/pallas_retrace.py:42",
        "launches": launches["batched_retrace"],
        "max_abs_err": max(kern["err"].values()),
        "ms": k_ms,
        "plain_ms": p_ms,
        "entry_points": {
            "batched_retrace": {
                "launches": launches["batched_retrace"],
                "max_abs_err": kern["err"]["batched_retrace"],
                "ms": k_ms, "plain_ms": p_ms,
                "gb_per_s": kern["gbps"]["batched_retrace"]},
            "affine_suffix_scan": {
                "launches": launches["affine_suffix_scan"],
                "max_abs_err": kern["err"]["affine_suffix_scan"],
                "ms": a_ms, "plain_ms": ap_ms,
                "gb_per_s": kern["gbps"]["affine_suffix_scan"]}},
        "build_s": kern["build_s"],
        "sites": {"vracer_main": main_res["sites"],
                  **{k: v["sites"] for k, v in learners.items()}},
        "launches_by_path": {"vracer_main": launches["batched_retrace"],
                             **{k: v["launches"]
                                for k, v in learners.items()}},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

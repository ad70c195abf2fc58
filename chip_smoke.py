#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (smarties_tpu_torch).

    python3 chip_smoke.py      # every phase, one CUDA card

Phases, each reported on its own line:
1. device: a CUDA card is required (exit 2 without one; there is no CPU
   fallback). Prints `nvidia-smi --query-gpu=name,power.limit` and turns
   TF32 off for matmuls and cuDNN.
2. kernels: builds K1 (csrc/retrace.cu) with nvcc from this checkout and
   holds its three entry points against their plain torch versions on
   the card at [200, 37], [33, 22], the main path's [4096, 501] and the
   [256, 501] and [1024, 501] of the PPO and GRU paths and the Atari
   path's [65536, 40], for Retrace and GAE: `affine_suffix_scan` and `batched_retrace` in the
   time-major layout the replay stores (bit-equal) and in row-major, the
   in-place `retrace_sweep_` with a mixed, a full and an empty select,
   both `zero_unselected` values and lengths 0 and L1-1 among the slots
   (bit-equal). Times every entry point at [4096, 501] with CUDA events
   on a cold L2 (runtime/bench_retrace.py's table: random and full
   lengths, the ingest's 1024 of 4096 slots) beside the bound its bytes
   set at 3.35 TB/s, a clone of as many bytes and the plain version;
   the sweep also at the PPO path's [256, 501] in GAE mode, the GRU
   path's [1024, 501] and the Atari path's [65536, 40].
3. reference: the port on the card against the port on the CPU at a
   small size, from one state (8 train steps and a refresh, so K1 runs
   inside the pipeline against its plain version).
4. main path: the V-RACER cart-pole trainer at full width (1024 envs x
   4096 slots x 501 steps, [128, 128] net, batch 256): warmup, two fused
   cycles (2048 grad steps, two 1000-step refreshes), one train() chunk
   and evaluate(32). Checks finiteness, the stored-step count, and that
   every call of K1's four sites made exactly one sweep launch.
5. learners: RACER, RACER-discrete, DQN, NAF, DPG and MixedPG, each
   through the launcher (smarties_tpu_torch.launch.run) at its recipe's
   published widths and batch with 1024 envs: warmup, train(1000) timed
   with CUDA events (so the 1000-step refresh runs), evaluate(8, 200).
   Checks finiteness and one sweep launch per call at ingest,
   initialize_stats and refresh on every Retrace path (DQN's recipe has
   no Retrace sweep: its 0 is measured and printed); then the port on
   the card against the port on the CPU at a small size (4 pinned train
   steps and a refresh).
6. on-policy: PPO on cartpole and on cartpole_discrete through the
   launcher at the recipe's widths (encoder [64] + heads [64], batch 64,
   horizon 2048, 10 epochs) with the launcher's default 64 envs (at
   1024 lanes one wave of a fresh policy's episodes exceeds the commit
   cap of 4 horizons and fresh data would be pruned): two whole horizon
   cycles (fill, 320 updates, the statistics refresh, clear_all), the
   train chunks timed with CUDA events, evaluate(8, 200). Checks that
   every K1 launch ran in GAE mode, one per ingest and one in
   initialize_stats, and none in PPO's refresh; then the card against the
   CPU at a small size.
7. recurrent: RACER_RNN (LSTM [32, 32], BPTT 16, batch 128) on
   cartpole.pomdp with the Trainer built as the main path's (1024 envs,
   4096 slots x 501 steps, training from 16384 observations): warmup,
   train(200), a refresh, evaluate(8, 200); the GRU recipe
   VRACER_expensiveData the same way at 1024 slots.
   Checks that every K1 launch ran in Retrace mode, one per site call;
   then LSTM and GRU V-RACER on the card against the CPU at a small size.
8. conv / Atari: app `catch` with recipe RACER_atari through the launcher
   at full width (RACER-discrete, the Mnih stack over 4 stacked 84x84
   frames + [512], batch 128, maxTotObsNum 262144, a uint8 replay of
   65,536 slots x 40 frames, 1024 envs, training from the recipe's 131072
   observations): warmup, train(300) by CUDA events, 10 env sweeps by
   events, a refresh, evaluate(8, 39). Prints the memory peak of the run
   and of initialize_stats alone (its chunked statistics must stay far
   below a second copy of the replay). Checks finiteness, the uint8
   storage and one Retrace launch of K1 per call at ingest,
   initialize_stats and refresh; then the conv learner on the card
   against the CPU on the 20x20 board (two conv layers, 2 appended
   frames, uint8 replay; cuDNN's f32 backward sums in another order than
   the CPU's, and the params stay within the other learners' rtol 1e-4 /
   atol 1e-6).
9. samplers: the main path's learner (V-RACER, 1024 envs, 4096 x 501
   slots, [128, 128], batch 256) under dataSamplingAlgo PERrank with
   ERoldSeqFilter farpolfrac: warmup, train_fused(100), which gives way
   to train(), and train(100), every step drawing from the TD errors the
   steps before wrote; then PERrank, PERerr and PERseq draws on the card
   against the CPU on a copy of the replay for the same injected
   uniforms (equal).
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
MAIN_E, MAIN_L1 = 4096, 501
# the Atari path's replay: the launcher's 2 * 262144 // 8 slots of catch's
# 39 steps
ATARI_E, ATARI_L1 = 65536, 40
# the replay shapes K1 meets on the other paths: PPO's 256 slots (GAE), the
# GRU recipe's 1024 and the Atari path's (Retrace); the learners and
# RACER_RNN use MAIN_E
PATH_SWEEPS = (("ppo", 256, MAIN_L1, "GAE"),
               ("vracer_gru", 1024, MAIN_L1, "retrace"),
               ("racer_atari", ATARI_E, ATARI_L1, "retrace"))
KERNEL_SHAPES = ((200, 37), (33, 22), (256, MAIN_L1), (1024, MAIN_L1),
                 (MAIN_E, MAIN_L1), (ATARI_E, ATARI_L1))
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
# the on-policy phase: two horizons of 320 updates each, 64 lanes
PPO_PATHS = (("ppo", "cartpole"), ("ppo_discrete", "cartpole_discrete"))
PPO_ENVS, PPO_STEPS = 64, 640
# the recurrent phase: (name, recipe, replay slots, minTotObsNum); 1024
# lanes each. RACER_RNN starts at the main path's 16384 observations (its
# settings leave the default of 131072, which 4096 slots of a fresh
# policy's short episodes cannot hold)
RNN_PATHS = (("racer_rnn", "RACER_RNN", 4096, 16384),
             ("vracer_gru", "VRACER_expensiveData", 1024, 4096))
RNN_ENVS, RNN_STEPS = 1024, 200
# the conv / Atari phase
ATARI_ENVS, ATARI_STEPS = 1024, 300
# the samplers phase: steps through train_fused and through train
PER_STEPS = 100


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


def _check_sweep(rng, E, L1, dev, check):
    """`retrace_sweep_` against `retrace_sweep_plain_` on time-major
    replay fields: Retrace and GAE, both zero_unselected values, a mixed,
    a full and an empty select, lengths 0 and L1-1 among the slots."""
    import numpy as np
    import torch
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.ops import returns as ret

    def f32(*shape):
        return torch.as_tensor(rng.randn(*shape).astype(np.float32),
                               device=dev)

    qret, r, v, adv = (f32(L1, E) for _ in range(4))
    rho, v_trunc = torch.exp(f32(L1, E)), f32(E)
    lens = rng.randint(0, L1, E)
    lens[:2] = [0, L1 - 1]
    lens = torch.as_tensor(lens.astype(np.int32), device=dev)
    terms = torch.as_tensor(rng.rand(E) > 0.5, device=dev)
    mean = torch.full((), 0.3, device=dev)
    scale = torch.full((), 1.7, device=dev)
    selects = {"mixed": torch.as_tensor(rng.rand(E) > 0.5, device=dev),
               "all": torch.ones(E, dtype=torch.bool, device=dev),
               "none": torch.zeros(E, dtype=torch.bool, device=dev)}
    for mode in ("retrace", "GAE"):
        for zero in (False, True):
            for tag, select in selects.items():
                got, want = qret.clone(), qret.clone()
                for fn, q in ((rk.retrace_sweep_, got),
                              (ret.retrace_sweep_plain_, want)):
                    fn(q, r, v, adv, rho, v_trunc, lens, terms, select,
                       mean, scale, 0.995, 0.95, mode, zero)
                check("retrace_sweep", got, want,
                      f"[{E},{L1}] {mode} select {tag} "
                      f"zero_unselected={zero}", True)


def phase_kernels():
    import numpy as np
    import torch
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.ops import returns as ret
    from smarties_tpu_torch.runtime import bench_retrace as bench

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rk.library()
    build_s = time.perf_counter() - t0
    nvcc_s = rk.build_info["seconds"]
    print(f"kernels: K1 built in {build_s:.2f} s (nvcc "
          f"{'cached' if nvcc_s is None else f'{nvcc_s:.2f} s'}) -> "
          f"{os.path.relpath(rk.build_info['path'])}", flush=True)
    for line in bench.ptxas_lines():
        print(f"  ptxas: {line}", flush=True)

    rng = np.random.RandomState(0)
    err = {"affine_suffix_scan": 0.0, "batched_retrace": 0.0,
           "retrace_sweep": 0.0}

    def check(name, got, want, what, exact):
        torch.cuda.synchronize()
        if exact:
            assert torch.equal(got, want), \
                f"{name} {what}: not bit-equal to the plain version, " \
                f"max |diff| {float((got - want).abs().max()):.3e}"
        else:
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                       msg=lambda m: f"{name} {what}: {m}")
        e = float((got - want).abs().max()) if got.numel() else 0.0
        err[name] = max(err[name], e)
        print(f"  {name} {what}: max|kernel - plain| = {e:.3e}"
              f"{' (bit-equal)' if exact else ''}", flush=True)

    for E, L1 in KERNEL_SHAPES:
        for tm in (True, False):
            lay = "time-major" if tm else "row-major"
            r, v, adv, rho, b, lens, terms = _retrace_inputs(rng, E, L1,
                                                             tm, dev)
            check("affine_suffix_scan", rk.affine_suffix_scan(r, b),
                  ret.affine_suffix_scan_plain(r, b), f"[{E},{L1}] {lay}",
                  tm)
            for mode in ("retrace", "GAE"):
                args = (r, v, adv, rho, lens, terms, 0.995, 0.95, mode)
                check("batched_retrace", rk.batched_retrace(*args),
                      ret.batched_retrace_plain(*args),
                      f"[{E},{L1}] {lay} {mode}", tm)
        _check_sweep(rng, E, L1, dev, check)

    # times at the main path's shape and layout, each launch on a cold L2
    rows = bench.measure(dev, n=30)
    for row in rows:
        print(f"kernels: {bench.format_row(row)}", flush=True)
    floor_ms = bench.launch_floor_ms(dev, n=30)
    print(f"kernels: a launch that selects no slot {floor_ms:.4f} ms",
          flush=True)
    plain = bench.plain_ms(dev, n=10)
    for name, ms in plain.items():
        print(f"kernels: plain torch version of {name}, Retrace, random "
              f"lengths: {ms:.4f} ms (median)", flush=True)
    path_rows = {}
    for path, E, L1, mode in PATH_SWEEPS:
        r = path_rows[path] = bench.measure_sweep_at(dev, E, L1, mode)
        print(f"kernels: retrace_sweep {mode} at the {path} path's "
              f"[{E}, {L1}]: kernel {r['ms']:.4f} ms | plain torch "
              f"version {r['plain_ms']:.4f} ms | {r['bytes']} B, bound "
              f"{r['bound_ms'] * 1e3:.2f} us, share of bound "
              f"{r['share_of_bound']:.3f} | clone of as many bytes "
              f"{r['clone_ms']:.4f} ms", flush=True)
    return {"build_s": build_s, "err": err, "rows": rows, "plain": plain,
            "floor_ms": floor_ms, "path_rows": path_rows}


class SiteCounter:
    """Attributes K1 launches to their sites by diffing the launch
    counters around the trainer's three return-sweep callables: per site
    the calls and the launches they made. The ingest sweep counts
    under `ingest_site`, which the main path sets per phase."""

    def __init__(self, trainer, rk):
        self.rk = rk
        self.ingest_site = "ingest"
        self.sites = {}
        self.calls = {}
        for attr, site in (("_fix_returns", "ingest"),
                           ("_init_stats", "initialize_stats"),
                           ("_refresh", "refresh")):
            setattr(trainer, attr, self._wrap(getattr(trainer, attr), site))

    def _wrap(self, fn, site):
        def counted(*a, **kw):
            n0 = sum(self.rk.launches.values())
            out = fn(*a, **kw)
            key = self.ingest_site if site == "ingest" else site
            self.sites[key] = (self.sites.get(key, 0)
                               + sum(self.rk.launches.values()) - n0)
            self.calls[key] = self.calls.get(key, 0) + 1
            return out
        return counted

    def check_one_launch_per_call(self, counts, expected_sites, what,
                                  no_sweep_sites=()):
        """Every call of a site made exactly one launch (none at a
        `no_sweep_sites` site, which must have been called), all of them
        through the fused sweep, and every expected site was reached."""
        for site in expected_sites:
            assert self.sites.get(site, 0) > 0, \
                f"{what}: K1 was not launched at the {site} site: " \
                f"{self.sites}"
        want = {k: 0 if k in no_sweep_sites else n
                for k, n in self.calls.items()}
        assert set(no_sweep_sites) <= set(self.calls), (what, self.calls)
        assert self.sites == want, \
            f"{what}: launches {self.sites} != calls {self.calls}"
        assert counts["retrace_sweep"] == sum(self.sites.values()) \
            == sum(counts.values()), (what, counts, self.sites)


def _leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict/list of tensors."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}{i}.")]
    return [(prefix.rstrip("."), tree)]


def _card_vs_cpu(env, cfg, n_steps, state_dtype=None):
    """The port on the card against the port on the CPU (whose K1 is the
    plain torch loop) at a small size, from the same state: the CPU
    trainer's warmup, then its params, optimiser state and replay copied
    to the card, n_steps train steps on the same pinned samples and a
    refresh on both. cuBLAS and the CPU BLAS reduce in another order (TF32
    off): rtol 1e-4; values pass through scale_net2v in RACER, which
    cancels two terms near 5100 (one f32 ulp is 4.9e-4): atol 2e-3 on V,
    TD errors and returns. The conv learner (cuDNN on the card) keeps
    these tolerances. Returns the worst |diff| of params, qret, rho and
    value."""
    import numpy as np
    import torch
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.runtime.trainer import Trainer

    size = dict(n_envs=16, n_slots=64, max_len=64, state_dtype=state_dtype)
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
    sites.check_one_launch_per_call(
        counts, ("warmup_train_ingest", "initialize_stats", "refresh",
                 "fused_cycle_ingest"), "main")

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
    print(f"main: K1 launches {counts} by site {site_counts}, one per "
          f"call of each site", flush=True)
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
        mode = tr.algo.returns_mode
        if mode == "none":
            assert sum(counts.values()) == 0 == sum(sites.values()), \
                (name, counts, sites)
            k1 = ("K1 launches 0, measured: returnsEstimator 'none' "
                  "(1-step targets) runs no Retrace sweep")
        else:
            hooks["sites"].check_one_launch_per_call(
                counts, ("ingest", "initialize_stats", "refresh"), name)
            k1 = f"K1 sweep launches by site {sites}, one per call"
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
        results[name] = {"sites": sites, "launches": counts["retrace_sweep"],
                         "ms_per_grad_step": ms_step,
                         "train_ms": hooks["train_ms"], "run_s": run_s,
                         "card_vs_cpu": worst}
    return results


def _check_finite(name, tr, rets, n_eval):
    import numpy as np
    import torch
    for k, p in _leaves(tr.params):
        assert torch.isfinite(p).all(), f"{name}: non-finite param {k}"
    for k, m in tr._last_metrics.items():
        assert torch.isfinite(m).all(), f"{name}: non-finite metric {k}"
    assert np.isfinite(rets).all() and rets.shape == (n_eval,), (name, rets)


def _fmt_diffs(worst):
    return ", ".join(f"{k} {v:.3e}" for k, v in worst.items())


def phase_on_policy():
    """PPO, continuous and discrete, through the launcher: two horizon
    cycles each; the train chunks timed with CUDA events; K1 counted per
    site and by mode; evaluate; the small-size reference against the
    CPU."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.ops import retrace_kernel as rk

    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    results = {}
    for name, app in PPO_PATHS:
        args = launch.parse_args([
            app, "--recipe", "PPO", "--device", "cuda", "--nEnvironments",
            str(PPO_ENVS), "--nTrainSteps", str(PPO_STEPS), "--runprefix",
            runs, "--runname", name])
        hooks = {"events": [], "cleared": [], "stored": []}

        def prepare(tr):
            tr.log_flush_threshold = 10 ** 9
            hooks["sites"] = SiteCounter(tr, rk)
            chunk, refresh = tr._train_chunk, tr._refresh

            def timed_chunk(n):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = chunk(n)
                e1.record()
                hooks["events"].append((e0, e1, n))
                return out

            def watched_refresh(rs, n):
                # the horizon as the updates saw it, before clear_all
                hooks["stored"].append(rs.n_stored_steps())
                return refresh(rs, n)

            tr._train_chunk, tr._refresh = timed_chunk, watched_refresh

        rk.reset_launches()
        t0 = time.perf_counter()
        tr = launch.run(args, prepare=prepare)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts, modes = dict(rk.launches), dict(rk.launch_modes)
        sites, calls = dict(hooks["sites"].sites), dict(hooks["sites"].calls)
        n_left = int(tr.replay.n_stored_steps())
        rets = tr.evaluate(8, max_steps=200)

        _check_finite(name, tr, rets, 8)
        cfg, algo = tr.cfg, tr.algo
        per_cycle = algo.n_epochs * algo.n_horizon // cfg.batchSize
        steps = sum(n for _, _, n in hooks["events"])
        assert tr.on_policy and algo.returns_mode == "GAE", name
        assert steps == tr.n_grad_steps == PPO_STEPS == 2 * per_cycle, \
            (name, steps, tr.n_grad_steps, per_cycle)
        assert calls["refresh"] == 2 and calls["initialize_stats"] == 1, \
            (name, calls)
        stored = [int(x) for x in hooks["stored"]]
        assert all(algo.n_horizon <= x <= 4 * algo.n_horizon
                   for x in stored), (name, stored)
        assert n_left == 0, f"{name}: replay not cleared: {n_left}"
        hooks["sites"].check_one_launch_per_call(
            counts, ("ingest", "initialize_stats"), name,
            no_sweep_sites=("refresh",))
        assert modes == {"retrace": 0, "GAE": counts["retrace_sweep"]}, \
            (name, modes, counts)
        train_ms = sum(e0.elapsed_time(e1) for e0, e1, _ in hooks["events"])
        ms_step = train_ms / steps
        worst = _card_vs_cpu(launch.env_module(app), _small_cfg("PPO"), 4)
        shutil.rmtree(tr.run_dir)
        print(f"on-policy: {name} (PPO, {app}, enc {cfg.encoderLayerSizes} "
              f"+ {cfg.nnLayerSizes}, batch {cfg.batchSize}, horizon "
              f"{algo.n_horizon}, {algo.n_epochs} epochs, {PPO_ENVS} envs): "
              f"2 horizon cycles, {steps} updates {train_ms:.1f} ms by "
              f"events ({ms_step:.3f} ms/grad step) | launch.run "
              f"{run_s:.2f} s, {tr.n_env_steps} env steps, horizons held "
              f"{stored} steps, cleared to {n_left} | evaluate(8, 200) mean "
              f"return {float(np.mean(rets)):.2f} | K1 sweep launches by "
              f"site {sites} of calls {calls}, by mode {modes} | card vs "
              f"CPU max |diff| {_fmt_diffs(worst)}", flush=True)
        results[name] = {"sites": sites, "launches": counts["retrace_sweep"],
                         "modes": modes, "ms_per_grad_step": ms_step,
                         "run_s": run_s, "card_vs_cpu": worst}
    return results


def phase_recurrent():
    """The recurrent recipes on the no-velocity cart-pole, the Trainer
    built directly at the main path's replay shape: warmup, train(n) by
    CUDA events, a refresh, evaluate; K1 per site, all in Retrace mode;
    then LSTM and GRU V-RACER on the card against the CPU."""
    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.trainer import Trainer

    env = cartpole.pomdp
    results = {}
    for name, recipe, n_slots, min_obs in RNN_PATHS:
        cfg = launch.load_recipe(recipe, 0)
        cfg.minTotObsNum = min_obs
        tr = Trainer(env, env.MDP, cfg, n_envs=RNN_ENVS, n_slots=n_slots,
                     max_len=env.MAX_STEPS, device="cuda")
        tr.log_flush_threshold = 10 ** 9
        assert tr.algo_is_recurrent and tr.algo.spec.kind == cfg.nnType
        assert tr.replay.rewards.shape == (n_slots, MAIN_L1)
        sites = SiteCounter(tr, rk)
        rk.reset_launches()
        t0 = time.perf_counter()
        tr.warmup()
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        tr.train(RNN_STEPS, log_every=10 ** 9)
        e1.record()
        e1.synchronize()
        train_s = time.perf_counter() - t0
        train_ms = e0.elapsed_time(e1)
        tr.carry = tr.carry._replace(
            replay=tr._refresh(tr.replay, float(tr.n_grad_steps)))
        counts, modes = dict(rk.launches), dict(rk.launch_modes)
        rets = tr.evaluate(8, max_steps=200)

        _check_finite(name, tr, rets, 8)
        assert tr.n_grad_steps == RNN_STEPS, (name, tr.n_grad_steps)
        sites.check_one_launch_per_call(
            counts, ("ingest", "initialize_stats", "refresh"), name)
        assert modes == {"retrace": counts["retrace_sweep"], "GAE": 0}, \
            (name, modes, counts)
        # the acting carry: one entry per layer, (h, c) pairs for the LSTM
        assert len(tr.carry.rnn) == len(cfg.nnLayerSizes), name
        worst = _card_vs_cpu(env, _small_cfg(recipe), 4)
        ms_step = train_ms / RNN_STEPS
        print(f"recurrent: {name} (VRacer, cartpole.pomdp, {cfg.nnType} "
              f"{cfg.nnLayerSizes}, BPTT {cfg.nnBPTTseq}, batch "
              f"{cfg.batchSize}, {RNN_ENVS} envs, {n_slots} x {MAIN_L1} "
              f"slots): warmup {warm_s:.2f} s | train({RNN_STEPS}) "
              f"{train_ms:.1f} ms by events ({ms_step:.3f} ms/grad step, "
              f"host wall {train_s:.2f} s) | stored steps "
              f"{int(tr.replay.n_stored_steps())} | evaluate(8, 200) mean "
              f"return {float(np.mean(rets)):.2f} | K1 sweep launches by "
              f"site {dict(sites.sites)}, one per call, by mode {modes} | "
              f"card vs CPU max |diff| {_fmt_diffs(worst)}", flush=True)
        results[name] = {"sites": dict(sites.sites),
                         "launches": counts["retrace_sweep"], "modes": modes,
                         "ms_per_grad_step": ms_step, "warmup_s": warm_s,
                         "card_vs_cpu": worst}
        del tr
        torch.cuda.empty_cache()
    return results


def phase_atari():
    """`catch` with RACER_atari through the launcher at full width."""
    import shutil

    import numpy as np
    import torch
    from smarties_tpu_torch import launch
    from smarties_tpu_torch.envs import catch
    from smarties_tpu_torch.ops import retrace_kernel as rk

    name = "racer_atari"
    runs = os.path.join(ROOT, "build", "chip_smoke_runs")
    args = launch.parse_args([
        "catch", "--recipe", "RACER_atari", "--device", "cuda",
        "--nEnvironments", str(ATARI_ENVS), "--nTrainSteps",
        str(ATARI_STEPS), "--runprefix", runs, "--runname", name,
        "--noCheckpoint"])
    hooks = {}
    gib = 2.0 ** 30

    def prepare(tr):
        tr.log_flush_threshold = 10 ** 9
        hooks["sites"] = SiteCounter(tr, rk)
        train, warmup, init_stats = tr.train, tr.warmup, tr._init_stats

        def timed_warmup(**kw):
            t0 = time.perf_counter()
            warmup(**kw)
            torch.cuda.synchronize()
            hooks.update(warmup_s=time.perf_counter() - t0,
                         warmup_sweeps=tr.n_env_steps // tr.n_envs)

        def watched_init_stats(rs):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = init_stats(rs)
            torch.cuda.synchronize()
            hooks.update(init_s=time.perf_counter() - t0, init_base=base,
                         init_peak=torch.cuda.max_memory_allocated())
            return out

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

        tr.train, tr.warmup, tr._init_stats = (timed_train, timed_warmup,
                                               watched_init_stats)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rk.reset_launches()
    t0 = time.perf_counter()
    tr = launch.run(args, prepare=prepare)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # initialize_stats reset the peak counter: the run's peak is the larger
    peak = max(hooks["init_peak"], torch.cuda.max_memory_allocated())
    rs = tr.replay
    states_bytes = rs.states_tm.numel() * rs.states_tm.element_size()

    # 10 env sweeps alone (act on stacked frames, env step, commit)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for _ in range(10):
        tr.carry, _ = tr._rollout(tr.params, tr.carry, 1)
    e1.record()
    sweep_enq_ms = (time.perf_counter() - t0) * 1e2
    e1.synchronize()
    sweep_ms = e0.elapsed_time(e1) / 10
    tr.carry = tr.carry._replace(
        replay=tr._refresh(tr.replay, float(tr.n_grad_steps)))
    counts, modes = dict(rk.launches), dict(rk.launch_modes)
    sites = dict(hooks["sites"].sites)
    rets = tr.evaluate(8, max_steps=catch.MAX_STEPS)
    peak = max(peak, torch.cuda.max_memory_allocated())

    _check_finite(name, tr, rets, 8)
    cfg = tr.cfg
    assert (cfg.batchSize, cfg.nnLayerSizes, cfg.maxTotObsNum,
            cfg.minTotObsNum) == (128, [512], 262144, 131072), cfg
    assert [tuple(getattr(c, f) for f in ("in_w", "in_h", "in_c", "out_c",
                                          "filter", "stride"))
            for c in tr.algo.spec.conv] == list(catch.CONV_STACK)
    assert rs.states_tm.dtype == torch.uint8
    assert tuple(rs.states_tm.shape) == (ATARI_L1, ATARI_E, 84 * 84)
    assert tr.carry.inprog.states.dtype == torch.uint8
    assert hooks["steps"] >= ATARI_STEPS, hooks
    n_stored = int(rs.n_stored_steps())
    assert n_stored >= cfg.minTotObsNum, n_stored
    assert set(np.unique(rets)) <= {-1.0, 1.0}, rets
    hooks["sites"].check_one_launch_per_call(
        counts, ("ingest", "initialize_stats", "refresh"), name)
    assert modes == {"retrace": counts["retrace_sweep"], "GAE": 0}, \
        (name, modes, counts)
    # the statistics pass never holds a second copy of the replay
    init_extra = hooks["init_peak"] - hooks["init_base"]
    assert init_extra < 0.5 * states_bytes, (init_extra, states_bytes)
    assert peak < 1.5 * states_bytes, (peak, states_bytes)
    ms_step = hooks["train_ms"] / hooks["steps"]
    print(f"atari: {name} ({type(tr.algo).__name__}, catch, Mnih conv + "
          f"{cfg.nnLayerSizes}, batch {cfg.batchSize}, {ATARI_ENVS} envs, "
          f"uint8 replay {ATARI_E} x {ATARI_L1} x 7056 = "
          f"{states_bytes / gib:.2f} GiB, minTotObsNum {cfg.minTotObsNum} "
          f"as published): warmup {hooks['warmup_s']:.2f} s for "
          f"{hooks['warmup_sweeps']} sweeps, initialize_stats "
          f"{hooks['init_s']:.2f} s of it with {init_extra / gib:.2f} GiB "
          f"above the {hooks['init_base'] / gib:.2f} GiB held | "
          f"train({ATARI_STEPS}) {hooks['train_ms']:.1f} ms by events "
          f"({ms_step:.3f} ms/grad step, host wall "
          f"{hooks['train_wall_s']:.2f} s) | env sweep {sweep_ms:.3f} ms by "
          f"events (host enqueue {sweep_enq_ms:.3f} ms) | launch.run "
          f"{run_s:.2f} s | stored steps {n_stored} | evaluate(8, 39) mean "
          f"return {float(np.mean(rets)):.2f} | memory peak "
          f"{peak / gib:.2f} GiB | K1 sweep launches by site {sites}, one "
          f"per call, by mode {modes}", flush=True)
    shutil.rmtree(tr.run_dir)
    del tr, rs
    torch.cuda.empty_cache()

    small_cfg = _small_cfg("RACER_atari")
    small_cfg.nnLayerSizes = [16]
    worst = _card_vs_cpu(catch.small, small_cfg, 4, state_dtype=torch.uint8)
    print(f"atari: conv learner on the card vs on the CPU (20x20 board, "
          f"conv {catch.small.CONV_STACK}, 2 appended frames, uint8 replay, "
          f"4 train steps + refresh): max |diff| {_fmt_diffs(worst)}",
          flush=True)
    return {name: {"sites": sites, "launches": counts["retrace_sweep"],
                   "modes": modes, "ms_per_grad_step": ms_step,
                   "ms_per_env_sweep": sweep_ms, "run_s": run_s,
                   "memory_peak_bytes": peak,
                   "init_stats_extra_bytes": init_extra,
                   "card_vs_cpu": worst}}


def phase_samplers():
    """The main path's learner under PERrank + farpolfrac, then every
    prioritized sampler's draw on the card against the CPU."""
    import numpy as np
    import torch
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.replay import buffer as rb
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters

    name = "vracer_perrank"
    cfg = HyperParameters(minTotObsNum=16384, maxTotObsNum=262144,
                          batchSize=256, obsPerStep=1.0,
                          nnLayerSizes=[128, 128], randSeed=0,
                          dataSamplingAlgo="PERrank",
                          ERoldSeqFilter="farpolfrac")
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=1024, n_slots=MAIN_E,
                 max_len=cartpole.MAX_STEPS, device="cuda")
    tr.log_flush_threshold = 10 ** 9
    sites = SiteCounter(tr, rk)
    rk.reset_launches()
    tr.warmup(chunk=16, blind_sweeps=16)
    assert not tr._can_presample
    ms = []
    for run in (tr.train_fused, tr.train):
        g0 = tr.n_grad_steps
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run(PER_STEPS, log_every=10 ** 9)
        e1.record()
        e1.synchronize()
        assert tr.n_grad_steps - g0 == PER_STEPS, (g0, tr.n_grad_steps)
        ms.append(e0.elapsed_time(e1) / PER_STEPS)
    counts = dict(rk.launches)
    rets = tr.evaluate(8, max_steps=200)
    _check_finite(name, tr, rets, 8)
    sites.check_one_launch_per_call(counts, ("ingest", "initialize_stats"),
                                    name)
    rs = tr.replay
    assert float(rs.delta_tm.abs().max()) > 0      # TD errors were written
    cpu = convert.replay_from_jax(convert.replay_to_numpy(rs), "cpu")
    rng = np.random.RandomState(0)
    agree = {}
    for algo in ("PERrank", "PERerr", "PERseq"):
        shape = (2, cfg.batchSize) if algo == "PERseq" else (cfg.batchSize,)
        u = torch.as_tensor(rng.rand(*shape).astype(np.float32))
        ep_c, t_c = rb.sample(None, cpu, cfg.batchSize, algo, u=u)
        ep_g, t_g = rb.sample(None, rs, cfg.batchSize, algo, u=u.cuda())
        assert torch.equal(ep_g.cpu(), ep_c) and torch.equal(t_g.cpu(), t_c), \
            f"{algo}: the card's draw differs from the CPU's"
        assert bool((t_c < cpu.slot_len[ep_c.long()]).all()), algo
        agree[algo] = int(torch.unique(ep_c).numel())
    print(f"samplers: {name} (VRacer, cartpole, [128, 128], batch 256, 1024 "
          f"envs, {MAIN_E} x {MAIN_L1} slots, PERrank + farpolfrac): "
          f"train_fused({PER_STEPS}) gave way to train(): {ms[0]:.3f} "
          f"ms/grad step by events with the sweeps that reach the start "
          f"threshold, train({PER_STEPS}) {ms[1]:.3f} | stored "
          f"steps {int(rs.n_stored_steps())} | evaluate(8, 200) mean return "
          f"{float(np.mean(rets)):.2f} | K1 sweep launches by site "
          f"{dict(sites.sites)}, one per call | draws of {cfg.batchSize} on "
          f"the card equal the CPU's for the same uniforms (distinct "
          f"episodes drawn: {agree})", flush=True)
    del tr
    torch.cuda.empty_cache()
    return {name: {"sites": dict(sites.sites),
                   "launches": counts["retrace_sweep"],
                   "ms_per_grad_step": ms[1]}}


def main():
    phase_device()
    import torch
    kern = phase_kernels()
    phase_reference()
    main_res = phase_main_path()
    learners = phase_learners()
    learners.update(phase_on_policy())
    learners.update(phase_recurrent())
    learners.update(phase_atari())
    learners.update(phase_samplers())
    launches = main_res["launches"]

    def row(entry, mode, case):
        return next(r for r in kern["rows"] if (r["entry"], r["mode"],
                                                r["case"]) == (entry, mode,
                                                               case))

    # per entry point: the Retrace case with random lengths (the affine
    # scan has one case), which the plain version is timed at as well
    entry_rows = {"retrace_sweep": row("retrace_sweep", "retrace", "random"),
                  "batched_retrace": row("batched_retrace", "retrace",
                                         "random"),
                  "affine_suffix_scan": row("affine_suffix_scan", "-",
                                            "all steps")}
    entry_points = {
        name: {"launches": launches[name],
               "max_abs_err": kern["err"][name], "ms": r["ms"],
               "plain_ms": kern["plain"][name], "bytes": r["bytes"],
               "bound_ms": r["bound_ms"], "bound_by": "bytes",
               "share_of_bound": r["share_of_bound"],
               "device_loop_ms": r["loop_ms"], "clone_ms": r["clone_ms"],
               "library_ms": None}
        for name, r in entry_rows.items()}
    sweep = entry_points["retrace_sweep"]
    print(json.dumps({"kernels": [{
        "name": "retrace_suffix_scan",
        "route": "cuda",
        "source": "smarties_tpu_torch/csrc/retrace.cu",
        "replaces": "smarties_tpu/ops/pallas_retrace.py:42",
        # the main path reaches the kernel through the fused sweep only
        "launches": sum(launches.values()),
        "max_abs_err": max(kern["err"].values()),
        "ms": sweep["ms"],
        "plain_ms": sweep["plain_ms"],
        "bound_ms": sweep["bound_ms"],
        "bound_by": "bytes",
        "share_of_bound": sweep["share_of_bound"],
        "library_ms": None,
        "entry_points": entry_points,
        "cases": kern["rows"],
        "path_cases": kern["path_rows"],
        "launch_floor_ms": kern["floor_ms"],
        "build_s": kern["build_s"],
        "sites": {"vracer_main": main_res["sites"],
                  **{k: v["sites"] for k, v in learners.items()}},
        "launches_by_path": {"vracer_main": launches["retrace_sweep"],
                             **{k: v["launches"]
                                for k, v in learners.items()}},
        "modes_by_path": {k: v["modes"] for k, v in learners.items()
                          if "modes" in v},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

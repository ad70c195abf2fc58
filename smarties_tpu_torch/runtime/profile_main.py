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
  overlap), the busy share of the profiled wall, the CUDA kernel
  launches and device kernels per call, and the five kernel names with
  the most device time;
- the two return sweeps (the ingest's refresh_new_returns, with no
  stale slot and with 1024 of them, and the 1000-step refresh) both
  ways in this one run: through the fused in-place sweep, one K1 launch
  per call, and through the composition it replaced (`composed_sweep_`:
  scaled rewards and the v_trunc substitution materialised, K1's plain
  device loop, a where and a copy), with the kernel launches of each.

    python3 -m smarties_tpu_torch.runtime.profile_main --path PPO RACER_RNN

profiles one grad step and one env sweep of each named path of
chip_smoke.py instead (`PATHS`: the learners through the launcher's
recipes at their published widths, PPO with 64 envs on a filled horizon,
the recurrent recipes on cartpole_pomdp) with the same columns: the
three times per call, then the profiled wall, device busy time, busy
share, kernel launches and device kernels per call.

    python3 -m smarties_tpu_torch.runtime.profile_main --path RACER_atari

profiles the grad step of the conv path on a synthetic replay, what the
JAX package's bench.py::build_atari builds: RACER-discrete with 6
actions, the Mnih stack 84x84x4 -> 32.8/4, 64.4/2, 64.3/1 -> [512], batch
128, a uint8 replay of 512 slots x 128 steps of random pixels made from a
seed, uniform minibatches drawn up front. Same columns, plus the FLOPs of
one step counted from the shapes (`step_flops`) and the rate they make
over the events' time; then one env sweep of `catch` at 1024 envs with
the recipe's learner.

Needs a CUDA card (exits 2 without one). Imports no JAX.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from smarties_tpu_torch import launch
from smarties_tpu_torch.algos.base import presample_uniform
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.envs import cartpole, catch
from smarties_tpu_torch.models.net import _mlp_in_dim
from smarties_tpu_torch.ops import retrace_kernel as rk
from smarties_tpu_torch.replay import buffer as rb
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
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    launches = sum(1 for e in prof.events()
                   if e.name.startswith("cudaLaunchKernel"))
    return {"wall_ms": wall_ms / n, "busy_ms": busy_ms / n,
            "busy_share": busy_ms / wall_ms, "launches": launches / n,
            "device_kernels": len(kernels) / n,
            "top_kernels": [(k[:60], us / 1e3 / n) for k, us in top]}


def composed_sweep_(rs, select, gamma, lam, mode, zero_unselected):
    """The replay's return sweep as it was composed before K1 had its
    fused entry point (same signature as buffer._sweep_returns_): the
    scaled rewards and the v_trunc substitution as full [L1, E] tensors,
    K1's plain device loop over every slot, then a where and a copy."""
    q = rk.batched_retrace(
        rs.scaled_rewards_tm().t(), rs.value_with_trunc_tm().t(),
        rs.advantage_tm.t(), rs.rho_tm.t(), rs.slot_len, rs.slot_term,
        gamma, lam, mode, pipelined=False).t()
    other = torch.zeros_like(rs.qret_tm) if zero_unselected else rs.qret_tm
    rs.qret_tm.copy_(torch.where(select[None, :], q, other))


# name: (app, recipe as the launcher takes it, envs, replay slots or None
# for the trainer's default, minTotObsNum override or None)
PATHS = {
    "RACER": ("cartpole", "RACER", 1024, None, None),
    "RACER_discrete": ("cartpole_discrete", "RACER", 1024, None, None),
    "DQN": ("cartpole_discrete", "DQN", 1024, None, None),
    "NAF": ("pendulum", "NAF", 1024, None, None),
    "DPG": ("pendulum", "DPG", 1024, None, None),
    "MixedPG": ("cartpole", '{"learner": "MixedPG"}', 1024, None, None),
    "PPO": ("cartpole", "PPO", 64, None, None),
    "PPO_discrete": ("cartpole_discrete", "PPO", 64, None, None),
    "RACER_RNN": ("cartpole_pomdp", "RACER_RNN", 1024, 4096, 16384),
    "VRACER_expensiveData": ("cartpole_pomdp", "VRACER_expensiveData", 1024,
                             1024, 4096),
}


def report_times(name, fn, n, warm: int = 1):
    for _ in range(warm):
        fn()
    ev, enq, tot = time_calls(fn, n)
    print(f"{name}: {ev:.3f} ms/call (events) | host enqueue "
          f"{enq:.3f} ms/call | host total {tot:.3f} ms/call (n={n})",
          flush=True)
    return ev


def report_profile(name, fn, n):
    p = profile_calls(fn, n)
    print(f"profile {name}: wall {p['wall_ms']:.3f} ms/call (profiled) "
          f"| device busy {p['busy_ms']:.3f} ms/call | busy share "
          f"{p['busy_share']:.4f} | kernel launches/call "
          f"{p['launches']:.1f} | device kernels/call "
          f"{p['device_kernels']:.1f} (n={n}) | longest device kernels, "
          f"ms/call: " + "; ".join(f"{k} {ms:.3f}"
                                   for k, ms in p["top_kernels"]),
          flush=True)


def step_flops(spec, n_forward: int, n_backward: int) -> int:
    """FLOPs (2 per multiply-add) of one grad step of a feed-forward net
    with a conv stack, counted from the shapes: the forward over
    n_forward inputs, and for n_backward of them the weight gradient of
    every layer and the input gradient of every layer but the first.
    Activations, biases and the optimiser are left out."""
    macs = [c.out_h * c.out_w * c.out_c * c.filter * c.filter * c.in_c
            for c in spec.conv]
    sizes = [_mlp_in_dim(spec), *spec.hidden, spec.n_out]
    macs += [a * b for a, b in zip(sizes[:-1], sizes[1:])]
    return 2 * (n_forward * sum(macs)
                + n_backward * (2 * sum(macs) - macs[0]))


def atari_setup(device, seed: int = 0, n_slots: int = 512,
                max_len: int = 128):
    """(learner, params, optimiser state, replay): RACER-discrete, 6
    actions, the Mnih stack over 4 stacked 84x84 frames, [512], batch 128,
    on a uint8 replay of n_slots full episodes of random pixels."""
    from smarties_tpu_torch.algos.vracer import VRacer
    mdp = MDPSpec(dim_state=84 * 84, dim_action=1, discrete_values=(6,),
                  n_appended_obs=3, conv_layers=catch.CONV_STACK)
    cfg = HyperParameters(batchSize=128, nnLayerSizes=[512], gamma=0.99,
                          minTotObsNum=16384, maxTotObsNum=262144)
    algo = VRacer(mdp, cfg)     # discrete: the RACER rewrite
    params, opt = algo.init(torch.Generator().manual_seed(seed), device)
    rs = rb.init_replay(n_slots, max_len, mdp.dim_state_observed,
                        mdp.dim_action, mdp.dim_policy, cfg.clipImpWeight,
                        mu_init=rb.safe_mu(mdp), device=device,
                        state_dtype=torch.uint8)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    rs.states_tm.random_(0, 256, generator=gen)
    rs.slot_id.copy_(torch.arange(n_slots, device=device))
    rs.slot_len.fill_(max_len)
    rs.rho_tm.fill_(1.0)
    return algo, params, opt, rb.rebuild_sample_cache(rs)


def profile_atari(n: int = 30, warm: int = 10):
    """The grad step of the conv path (times, profile, FLOPs), then one
    env sweep of `catch` with the same learner."""
    algo, params, opt, rs = atari_setup("cuda")
    cfg = algo.cfg
    gen = torch.Generator(device="cuda").manual_seed(2)
    eps, ts = presample_uniform(gen, rs, cfg.batchSize, 2 * (n + warm))
    state = {"p": params, "o": opt, "rs": rs, "i": 0}

    def train_step():
        i = state["i"] % eps.shape[0]
        state["p"], state["o"], state["rs"], _ = algo.train_step(
            state["p"], state["o"], state["rs"],
            sample_override=(eps[i], ts[i]))
        state["i"] += 1

    what = (f"RACER_atari (VRacer, synthetic uint8 replay "
            f"{rs.n_slots} x {rs.max_len + 1} x 84x84, Mnih conv + "
            f"{cfg.nnLayerSizes}, 6 actions, batch {cfg.batchSize}) "
            f"train_step")
    ev = report_times(what, train_step, n, warm=warm)
    report_profile(what, train_step, n)
    # [s_t; s_t1] go forward together; the backward runs over both halves
    # (the s_t1 rows with a zero cotangent)
    flops = step_flops(algo.spec, 2 * cfg.batchSize, 2 * cfg.batchSize)
    print(f"{what}: {flops / 1e9:.3f} GFLOP/step from the shapes "
          f"({2 * cfg.batchSize} inputs forward and backward) | "
          f"{flops / ev / 1e9:.3f} TFLOP/s f32 over the events' time | "
          f"memory peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB", flush=True)

    # one env sweep of catch with the recipe's learner: two renders, the
    # act forward over 1024 stacked images, the commit of uint8 frames.
    # 2048 slots: a sweep touches the lanes' slots only
    n_envs = 1024
    tr = Trainer(catch, catch.MDP, launch.load_recipe("RACER_atari", 0),
                 n_envs=n_envs, n_slots=2048, max_len=catch.MAX_STEPS,
                 device="cuda", state_dtype=torch.uint8)

    def roll():
        tr.carry, _ = tr._rollout(tr.params, tr.carry, 1)

    what = (f"RACER_atari (Racer, catch, {n_envs} envs, uint8 replay 2048 x "
            f"{catch.MAX_STEPS + 1} x 84x84) env sweep")
    report_times(what, roll, 10, warm=warm)
    report_profile(what, roll, 10)


def profile_path(name: str):
    """One grad step and one env sweep of a named path, on data gathered
    as its trainer gathers it (an off-policy warmup, or a filled PPO
    horizon with initialize_stats done)."""
    app, recipe, n_envs, n_slots, min_obs = PATHS[name]
    env = launch.env_module(app)
    cfg = launch.load_recipe(recipe, 0)
    if min_obs is not None:
        cfg.minTotObsNum = min_obs
    tr = Trainer(env, env.MDP, cfg, n_envs=n_envs, n_slots=n_slots,
                 max_len=env.MAX_STEPS, device="cuda")
    tr.log_flush_threshold = 10 ** 9
    if tr.on_policy:
        while int(tr.replay.n_stored_steps()) < tr.algo.n_horizon:
            tr._roll(4)
        tr.carry = tr.carry._replace(replay=tr._init_stats(tr.replay))
    else:
        tr.warmup()
    eps, ts = presample_uniform(tr.gen_batch, tr.replay, cfg.batchSize, 1)

    def roll():
        tr.carry, _ = tr._rollout(tr.params, tr.carry, 1)

    def train_step():
        tr.params, tr.opt_state, rs, _ = tr.algo.train_step(
            tr.params, tr.opt_state, tr.replay,
            sample_override=(eps[0], ts[0]))
        tr.carry = tr.carry._replace(replay=rs)

    what = (f"{name} ({type(tr.algo).__name__}, {app}, {cfg.nnType} "
            f"{cfg.nnLayerSizes}, batch {cfg.batchSize}, {n_envs} envs)")
    # the step first: the sweeps would commit episodes under the sample.
    # 10 calls first: the first ones pay cuBLAS's and the allocator's set-up
    for part, fn, n in (("train_step", train_step, 30),
                        ("env sweep", roll, 10)):
        report_times(f"{what} {part}", fn, n, warm=10)
        report_profile(f"{what} {part}", fn, n)


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m smarties_tpu_torch.runtime.profile_main")
    p.add_argument("--path", nargs="+",
                   choices=sorted(PATHS) + ["RACER_atari"], default=(),
                   help="profile a grad step and an env sweep of these "
                        "paths (RACER_atari: the conv grad step on a "
                        "synthetic replay) instead of the V-RACER main "
                        "path's report")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_main: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    # f32 throughout, as the Trainer sets it: no TF32 in matmuls or convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    for name in args.path:
        if name == "RACER_atari":
            profile_atari()
        else:
            profile_path(name)
    if args.path:
        return
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
        report_times(name, fn, n)

    for name, fn, n in (("train_step", train_step, 20),
                        ("env sweep", roll, 5)):
        report_profile(name, fn, n)

    # the return sweeps, fused and as composed before, in turns
    some_stale = torch.zeros_like(tr.replay.qret_stale)
    some_stale[torch.randperm(
        tr.replay.n_slots, generator=torch.Generator().manual_seed(0)
    )[:1024].to(some_stale.device)] = True

    def ingest_some_stale():
        tr.replay.qret_stale.copy_(some_stale)   # one launch of its own
        ingest()

    sweeps = (("ingest sweep, no stale slot", ingest),
              ("ingest sweep, 1024 stale slots (+1 launch to mark them)",
               ingest_some_stale),
              ("refresh", refresh))
    fused = rb._sweep_returns_
    for way, impl in (("composed", composed_sweep_), ("fused", fused),
                      ("fused", fused), ("composed", composed_sweep_)):
        rb._sweep_returns_ = impl
        try:
            for name, fn in sweeps:
                fn()
                k0 = sum(rk.launches.values())
                ev, enq, tot = time_calls(fn, 20)
                k1 = (sum(rk.launches.values()) - k0) / 20
                print(f"{name} [{way}]: {ev:.3f} ms/call (events) | host "
                      f"enqueue {enq:.3f} ms/call | host total {tot:.3f} "
                      f"ms/call | K1 launches/call {k1:.1f} (n=20)",
                      flush=True)
                report_profile(f"{name} [{way}]", fn, 10)
        finally:
            rb._sweep_returns_ = fused


if __name__ == "__main__":
    main()

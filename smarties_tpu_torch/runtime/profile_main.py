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
  stale slot and with 1024 of them, and the 1000-step refresh) through
  the fused in-place sweep, with K1's launches per call (one);
- the compiled programs (runtime/graphs.py) against the eager loops, in
  turns captured, eager, eager, captured: a train chunk of 100 grad
  steps (ms per grad step) and an env sweep with its ingest, each with
  the three times and the profile (kernel launches, graph launches and
  copies per call), from two trainers built alike, one with
  graphs=False; the chunk of 100 steps also as one graph of 100 steps
  per launch, beside the step graph replayed 100 times.

    python3 -m smarties_tpu_torch.runtime.profile_main --path PPO RACER_RNN

profiles one grad step and one env sweep of each named path of
chip_smoke.py instead (`PATHS`: the learners through the launcher's
recipes at their published widths, PPO with 64 envs on a filled horizon,
the recurrent recipes on cartpole_pomdp, ACER on pendulum with its
200-step episode windows, RACER-ES (VRACER_CMA, a population of 60)
on cartpole, RACER_glider on the glider and VRACER on predator-prey's
1024 lanes) with the same columns: the three times per call, then the
profiled wall, device busy time, busy share, kernel launches and device
kernels per call. The step's minibatch is drawn once, as the trainer
draws it (ACER: its episode and window-start draw), or by each step where
the trainer draws inside the step (VRACER_PERrank: the main path's
V-RACER under PERrank + farpolfrac).

    python3 -m smarties_tpu_torch.runtime.profile_main --graphs --path \
        RACER DQN VRACER_PERrank

compares each named path's compiled programs (runtime/graphs.py) with its
eager loops instead, as the main path's report does: two trainers built
alike, their graphs captured, then in turns captured, eager, eager,
captured a train chunk of 100 grad steps (ms per grad step) and an env
sweep with its ingest, the three times and the profile (kernel launches,
graph launches and copies per call) each, and the pools' bytes.

    python3 -m smarties_tpu_torch.runtime.profile_main --path RACER_atari

profiles the grad step of the conv path on a synthetic replay, what the
JAX package's bench.py::build_atari builds: RACER-discrete with 6
actions, the Mnih stack 84x84x4 -> 32.8/4, 64.4/2, 64.3/1 -> [512], batch
128, a uint8 replay of 512 slots x 128 steps of random pixels made from a
seed, uniform minibatches drawn up front. Same columns, plus the FLOPs of
one step counted from the shapes (`step_flops`) and the rate they make
over the events' time; then one env sweep of `catch` at 1024 envs with
the recipe's learner.

    python3 -m smarties_tpu_torch.runtime.profile_main --trace 60 \
        --trace-out main.trace.json

runs the main path with the phase profiler tracing (utils/profiler.py)
from the Trainer's construction instead: the replay filled by 256
sweeps, then fused cycles for 60 s, and one JSON line per cycle from its
span records: the median STEP replay's device ms, the median ms of each
of its stamped phases (gather, forward, backward, Adam, write-back) and
their sum, the TRAIN span's device ms per grad step, PRESAMPLE's device
ms and the share of the cycle's window the card was idle between the
program's spans; then each phase's kernels and their device µs in 8
replays of the traced step graph under torch.profiler (CUPTI). Then the
cost of tracing, in turns plain, traced, traced, plain of 3 cycles
each: TRAIN ms per grad step, and the host's µs per replay of 64
replays launched on an idle card; the card timer's resolution and the
mapping's measured error, the launches of the Adam, step-tail,
continuous-head and LSTM window kernels since the Trainer's construction
(`launches`: one update, one advance, one grad_stats and one step_tail a
grad step, one continuous head a V-RACER step, and one forward, one
backward and one reduce of the window a step of an LSTM that the window
kernel takes); and the Chrome
trace of one more traced cycle at --trace-out. `--trace-after S` runs S
seconds of plain cycles first
(each one's TRAIN ms per grad step printed) and turns tracing on after
them (the traced step graph is then captured late). `--trace-atari`
traces RACER_atari on catch instead (`atari_trainer`: 1024 envs, the
launcher's 65,536 x 40 uint8 slots, filled by 156 sweeps, four whole
episodes of every env): its step has the phases gather, conv_forward,
forward, backward, conv_backward, Adam and write-back, and each row adds
the conv stack's forward multiply-adds a replay and the TFLOP/s its
FLOPs make over the two conv phases (Profiler.summary). `--trace-rnn`
traces RACER_RNN on cartpole.pomdp instead (`rnn_trainer`: LSTM [32, 32],
a 16-step BPTT window, batch 128, 1024 envs, the main path's 4096 x 501
slots, filled by 256 sweeps): its step has the phases gather,
bptt_forward, head, bptt_backward, Adam and write-back, and each row adds
the window's cell applications a replay, their forward multiply-adds and
the µs of one cell application (Profiler.summary).

Needs a CUDA card (exits 2 without one). Imports no JAX.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

import torch

from smarties_tpu_torch import launch
from smarties_tpu_torch.algos.base import presample_uniform
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.envs import cartpole, catch
from smarties_tpu_torch.models.net import _mlp_in_dim
from smarties_tpu_torch.ops import (adam_kernel, cuda_lib,
                                    lstm_window_kernel, policy_head_kernel,
                                    step_tail_kernel)
from smarties_tpu_torch.ops import retrace_kernel as rk
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.runtime.trainer import Trainer, set_precision
from smarties_tpu_torch.utils.config import HyperParameters


def main_path_trainer(seed: int = 0, device="cuda", n_envs: int = 1024,
                      n_slots: int = 4096, graphs=None) -> Trainer:
    """The main path's V-RACER cart-pole trainer, the JAX package's
    bench.py::_build_trainer: [128, 128], batch 256, obsPerStep 1,
    minTotObsNum 16384, maxTotObsNum 262144, episodes up to 500 steps,
    episode logs held on the device. The bench, this profiler and
    chip_smoke.py build it here; the tests pass a smaller n_envs and
    n_slots. On a card it captures its sweep and step (Trainer's
    `graphs`; False: the eager loops)."""
    cfg = HyperParameters(minTotObsNum=16384, maxTotObsNum=262144,
                          batchSize=256, obsPerStep=1.0,
                          nnLayerSizes=[128, 128], randSeed=seed)
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=n_envs, n_slots=n_slots,
                 max_len=cartpole.MAX_STEPS, device=device, graphs=graphs)
    tr.log_flush_threshold = 10 ** 9
    return tr


def atari_trainer(seed: int = 0, device="cuda", n_envs: int = 1024,
                  n_slots=None, graphs=None) -> Trainer:
    """RACER_atari on catch as the launcher builds it: the recipe's
    RACER-discrete over the Mnih stack and [512], batch 128, episodes of
    catch's 39 steps, a uint8 replay (n_slots None: the Trainer's 65,536
    at the recipe's maxTotObsNum), episode logs held on the device."""
    from smarties_tpu_torch.utils.recipes import RECIPES
    cfg = HyperParameters.from_dict(dict(RECIPES["RACER_atari"],
                                         randSeed=seed))
    tr = Trainer(catch, catch.MDP, cfg, n_envs=n_envs, n_slots=n_slots,
                 max_len=catch.MAX_STEPS, device=device,
                 state_dtype=torch.uint8, graphs=graphs)
    tr.log_flush_threshold = 10 ** 9
    return tr


def rnn_trainer(seed: int = 0, device="cuda", n_envs: int = 1024,
                n_slots: int = 4096, graphs=None) -> Trainer:
    """RACER_RNN on the no-velocity cart-pole: the recipe's V-RACER with
    an LSTM [32, 32], a 16-step BPTT window and batch 128, on the main
    path's replay shape, episode logs held on the device."""
    from smarties_tpu_torch.utils.recipes import RECIPES
    cfg = HyperParameters.from_dict(dict(RECIPES["RACER_RNN"],
                                         randSeed=seed))
    env = cartpole.pomdp
    tr = Trainer(env, env.MDP, cfg, n_envs=n_envs, n_slots=n_slots,
                 max_len=env.MAX_STEPS, device=device, graphs=graphs)
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
    names = [e.name for e in prof.events()]
    launches = sum(1 for x in names if x.startswith("cudaLaunchKernel"))
    counts = {}
    for e in kernels:
        counts[e.name] = counts.get(e.name, 0) + 1
    return {"wall_ms": wall_ms / n, "busy_ms": busy_ms / n,
            "busy_share": busy_ms / wall_ms, "launches": launches / n,
            "graph_launches": names.count("cudaGraphLaunch") / n,
            "copies": sum(1 for x in names if x.startswith(
                ("cudaMemcpy", "cudaMemset"))) / n,
            "device_kernels": len(kernels) / n,
            "top_kernels": [(k[:60], us / 1e3 / n) for k, us in top],
            "kernel_counts": counts}


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
    "ACER": ("pendulum", "ACER", 1024, None, None),
    "VRACER_CMA": ("cartpole", "VRACER_CMA", 1024, None, None),
    "RACER_glider": ("glider", "RACER_glider", 1024, None, None),
    "VRACER_predator_prey": ("predator_prey", "VRACER", 1024, None, None),
    # the main path's V-RACER under PERrank + farpolfrac (chip_smoke.py's
    # samplers phase)
    "VRACER_PERrank": ("cartpole", json.dumps(
        {"learner": "VRACER", "batchSize": 256, "nnLayerSizes": [128, 128],
         "dataSamplingAlgo": "PERrank", "ERoldSeqFilter": "farpolfrac"}),
        1024, 4096, 16384),
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
          f"{p['launches']:.1f} | graph launches/call "
          f"{p['graph_launches']:.1f} | memcpy/memset calls/call "
          f"{p['copies']:.1f} | device kernels/call "
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
                max_len: int = 128, bf16: bool = False):
    """(learner, params, optimiser state, replay): RACER-discrete, 6
    actions, the Mnih stack over 4 stacked 84x84 frames, [512], batch 128,
    on a uint8 replay of n_slots full episodes of random pixels; `bf16`:
    the nnBf16 compute type."""
    from smarties_tpu_torch.algos.vracer import VRacer
    mdp = MDPSpec(dim_state=84 * 84, dim_action=1, discrete_values=(6,),
                  n_appended_obs=3, conv_layers=catch.CONV_STACK)
    cfg = HyperParameters(batchSize=128, nnLayerSizes=[512], gamma=0.99,
                          minTotObsNum=16384, maxTotObsNum=262144,
                          nnBf16=bf16)
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


def path_trainer(name: str, graphs=None) -> Trainer:
    """The Trainer of a named path (`PATHS`), as its phase builds it."""
    app, recipe, n_envs, n_slots, min_obs = PATHS[name]
    env = launch.env_module(app)
    cfg = launch.load_recipe(recipe, 0)
    if min_obs is not None:
        cfg.minTotObsNum = min_obs
    tr = Trainer(env, env.MDP, cfg, n_envs=n_envs, n_slots=n_slots,
                 max_len=env.MAX_STEPS, device="cuda", graphs=graphs)
    tr.log_flush_threshold = 10 ** 9
    return tr


def profile_path(name: str):
    """One grad step and one env sweep of a named path, on data gathered
    as its trainer gathers it (an off-policy warmup, or a filled PPO
    horizon with initialize_stats done), eagerly. The step's minibatch is
    drawn once, as the trainer draws it up front, or by the step itself
    where the trainer cannot presample (the prioritized samplers)."""
    tr = path_trainer(name, graphs=False)
    cfg = tr.cfg
    if tr.on_policy:
        while int(tr.replay.n_stored_steps()) < tr.algo.n_horizon:
            tr._roll(4)
        tr.carry = tr.carry._replace(replay=tr._init_stats(tr.replay))
    else:
        tr.warmup()
    draw = getattr(tr.algo, "presample_fn", presample_uniform)
    pinned = (tuple(x[0] for x in draw(tr.gen_batch, tr.replay,
                                       cfg.batchSize, 1))
              if tr._can_presample else None)

    def roll():
        tr.carry, _ = tr._rollout(tr.params, tr.carry, 1)

    def train_step():
        tr.params, tr.opt_state, rs, _ = tr.algo.train_step(
            tr.params, tr.opt_state, tr.replay, gen=tr.gen_batch,
            sample_override=pinned)
        tr.carry = tr.carry._replace(replay=rs)

    what = (f"{name} ({type(tr.algo).__name__}, {PATHS[name][0]}, "
            f"{cfg.nnType} {cfg.nnLayerSizes}, batch {cfg.batchSize}, "
            f"{tr.n_envs} envs)")
    # the step first: the sweeps would commit episodes under the sample.
    # 10 calls first: the first ones pay cuBLAS's and the allocator's set-up
    for part, fn, n in (("train_step", train_step, 30),
                        ("env sweep", roll, 10)):
        report_times(f"{what} {part}", fn, n, warm=10)
        report_profile(f"{what} {part}", fn, n)


def compare_path_graphs(name: str, steps: int = 100):
    """A named path's compiled programs against its eager loops: two
    trainers built alike, warmed up, their graphs captured in
    WARMUP_CALLS + 1 short fused cycles (1 sweep + 8 grad steps; the
    eager one takes the same), then compare_turns."""
    from smarties_tpu_torch.runtime import graphs as cg
    pair = []
    for graphs in (None, False):
        tr = path_trainer(name, graphs)
        assert tr.graphs == (graphs is None), (name, tr.graphs)
        tr.warmup()
        for _ in range(cg.WARMUP_CALLS + 1):
            tr._fused_cycle(1, 8)
        pair.append(tr)
    compare_turns(name, *pair, steps)
    del pair, tr
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m smarties_tpu_torch.runtime.profile_main")
    p.add_argument("--path", nargs="+",
                   choices=sorted(PATHS) + ["RACER_atari"], default=(),
                   help="profile a grad step and an env sweep of these "
                        "paths (RACER_atari: the conv grad step on a "
                        "synthetic replay) instead of the V-RACER main "
                        "path's report")
    p.add_argument("--graphs", action="store_true",
                   help="with --path: compare each path's captured grad "
                        "step and env sweep with its eager loops "
                        "(compare_turns) instead of profiling it eagerly")
    p.add_argument("--trace", type=float, default=None, metavar="SECONDS",
                   help="run the main path's fused cycles traced for this "
                        "long and report their spans and phases "
                        "(trace_main) instead")
    p.add_argument("--trace-after", type=float, default=0.0,
                   metavar="SECONDS",
                   help="with --trace: plain cycles for this long first")
    p.add_argument("--trace-out", default=None,
                   help="with --trace: write the Chrome trace of one traced "
                        "cycle here")
    p.add_argument("--trace-atari", action="store_true",
                   help="with --trace: RACER_atari on catch in place of "
                        "the main path")
    p.add_argument("--trace-rnn", action="store_true",
                   help="with --trace: RACER_RNN on cartpole.pomdp in "
                        "place of the main path")
    args = p.parse_args(argv)
    if args.graphs and (not args.path or "RACER_atari" in args.path):
        p.error("--graphs needs --path, without RACER_atari")
    if not torch.cuda.is_available():
        print("profile_main: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    set_precision()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0], flush=True)
    for name in args.path:
        if args.graphs:
            compare_path_graphs(name)
        elif name == "RACER_atari":
            profile_atari()
        else:
            profile_path(name)
    if args.trace is not None:
        trace_main(args.trace, args.trace_after, args.trace_out,
                   fill_sweeps=4 * catch.MAX_STEPS if args.trace_atari
                   else 256, atari=args.trace_atari, rnn=args.trace_rnn)
        return
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
    print(f"launches: {kernel_launches(tr)}", flush=True)

    for name, fn, n in (("train_step", train_step, 20),
                        ("env sweep", roll, 5)):
        report_profile(name, fn, n)

    # the return sweeps
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
    for name, fn in sweeps:
        fn()
        k0 = sum(rk.launches.values())
        ev, enq, tot = time_calls(fn, 20)
        k1 = (sum(rk.launches.values()) - k0) / 20
        print(f"{name}: {ev:.3f} ms/call (events) | host enqueue "
              f"{enq:.3f} ms/call | host total {tot:.3f} ms/call | K1 "
              f"launches/call {k1:.1f} (n=20)", flush=True)
        report_profile(name, fn, 10)
    compare_graphs(tr)


def compare_turns(name: str, cap: Trainer, eag: Trainer, steps: int = 100):
    """A captured trainer against an eager one built alike, in turns
    captured, eager, eager, captured: a train chunk of `steps` grad steps
    and an env sweep with its ingest, three times and a profile each
    (kernel launches, graph launches and copies per call); then the
    captured programs' pool bytes."""
    for label, t in (("captured", cap), ("eager", eag), ("eager", eag),
                     ("captured", cap)):
        chunk = f"{name} train chunk of {steps} grad steps [{label}]"
        ev = report_times(chunk, lambda: t._train_chunk(steps), 3)
        print(f"{chunk}: {ev / steps:.4f} ms per grad step (events)",
              flush=True)
        report_profile(chunk, lambda: t._train_chunk(steps), 2)
        sweep = f"{name} env sweep + ingest sweep [{label}]"
        report_times(sweep, lambda: t._sweep(1), 10)
        report_profile(sweep, lambda: t._sweep(1), 5)
    eag._pending_logs.clear()
    print(f"{name} graph pools: {cap.graph_pool_bytes()} B", flush=True)


def compare_graphs(tr: Trainer, steps: int = 100):
    """The captured main path (`tr`) against an eager trainer built alike
    (compare_turns); then the chunk as one graph of `steps` grad steps
    per launch (the step program captured `steps` times over), timed
    beside the step graph."""
    from smarties_tpu_torch.runtime import graphs as cg
    te = main_path_trainer(graphs=False)
    te.warmup(chunk=16, blind_sweeps=16)
    te.train_fused(te.n_envs, log_every=10 ** 9, flush=False)
    compare_turns("main path", tr, te, steps)

    # one graph launch per `steps` grad steps: the step program of `tr`
    # captured `steps` times, on its own static rows
    i = tr._step_rows[1]
    one = tr._step_graphs[True]

    def many(state):
        for _ in range(steps):
            state, _ = one.fn(state)
        return state, None

    chunk_graph = cg.Graph(many, one.state, device=tr.device)

    def replay_chunk():
        i.zero_()
        chunk_graph()

    for label, fn in (("step graph x %d" % steps,
                       lambda: tr._train_chunk(steps)),
                      (f"one graph of {steps} steps", replay_chunk),
                      (f"one graph of {steps} steps", replay_chunk),
                      ("step graph x %d" % steps,
                       lambda: tr._train_chunk(steps))):
        ev = report_times(f"{label} [captured]", fn, 5,
                          warm=cg.WARMUP_CALLS + 1)
        print(f"{label} [captured]: {ev / steps:.4f} ms per grad step "
              f"(events)", flush=True)
    print(f"graph pools: {tr.graph_pool_bytes() / 2 ** 20:.1f} MiB for "
          f"the sweep and step graphs, {chunk_graph.pool_bytes / 2 ** 20:.1f}"
          f" MiB for the {steps}-step graph", flush=True)


def phase_kernels(tr: Trainer, n: int = 8) -> dict:
    """The device kernels of each stamped phase of a trainer's traced
    step graph over n replays, from CUPTI (torch.profiler): per phase the
    kernels between the stamp that opens it and the one that closes it,
    and their summed device µs, medians over the replays (memory copies
    and sets not counted)."""
    from torch.profiler import ProfilerActivity, profile
    graph = tr._step_graphs[(True, "traced")]
    names = tr.algo.step_phases
    tr._step_rows[1].zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            graph()
        torch.cuda.synchronize()
    kernels = sorted(
        (e for e in prof.events()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not e.name.startswith(("Memcpy", "Memset"))),
        key=lambda e: e.time_range.start)
    marks = [j for j, e in enumerate(kernels) if "stamp_kernel" in e.name]
    per = len(names) + 1
    if len(marks) != n * per:
        raise RuntimeError(f"phase_kernels: {len(marks)} stamps in {n} "
                           f"replays, not {n * per}")
    counts = {k: [] for k in names}
    busy = {k: [] for k in names}
    for r in range(n):
        m = marks[r * per:(r + 1) * per]
        for k, name in enumerate(names):
            inside = kernels[m[k] + 1:m[k + 1]]
            counts[name].append(len(inside))
            busy[name].append(sum(e.time_range.elapsed_us()
                                  for e in inside))
    return {"kernels": {k: statistics.median(v) for k, v in counts.items()},
            "busy_us": {k: statistics.median(v) for k, v in busy.items()},
            "replays": n,
            "kernels_per_replay": len(kernels) / n}


def kernel_launches(tr: Trainer) -> dict:
    """The Adam, step-tail, continuous-head and LSTM window kernels'
    launch counters beside the grad steps the trainer's optimiser has
    taken."""
    opt = tr.opt_state
    return {"grad_steps": int((opt if hasattr(opt, "step")
                               else opt.adam).step),
            "adam": dict(adam_kernel.launches),
            "step_tail": dict(step_tail_kernel.launches),
            "policy_head": dict(policy_head_kernel.launches),
            "lstm_window": dict(lstm_window_kernel.launches)}


def trace_main(seconds: float, plain_s: float = 0.0, out=None,
               device="cuda", n_envs: int = 1024, n_slots: int = 4096,
               fill_sweeps: int = 256, atari: bool = False,
               rnn: bool = False):
    """The main path's fused cycles with the profiler tracing (the module
    docstring, --trace): from the Trainer's construction, or after
    `plain_s` seconds of plain cycles (each one's TRAIN ms per grad
    step printed). Prints JSON lines; returns the
    per-cycle rows. The tests pass the CPU (the graphs' static-buffer
    form) and smaller sizes. atari: RACER_atari on catch
    (`atari_trainer`, its replay's slots the Trainer's own) in place of
    the main path; rnn: RACER_RNN on cartpole.pomdp (`rnn_trainer`)."""
    from smarties_tpu_torch.ops.stamp import timer_ticks_ns
    cuda_lib.reset_launches()
    if atari:
        tr = atari_trainer(device=device, n_envs=n_envs, graphs=True)
    elif rnn:
        tr = rnn_trainer(device=device, n_envs=n_envs, n_slots=n_slots,
                         graphs=True)
    else:
        tr = main_path_trainer(device=device, n_envs=n_envs,
                               n_slots=n_slots, graphs=True)
    prof = tr.profiler
    cuda = tr.device.type == "cuda"
    if not plain_s:
        prof.trace()
    tr.warmup(chunk=1, blind_sweeps=fill_sweeps)
    n_train = tr.n_envs

    def cycles(s):
        """Fused cycles for s seconds -> [(cycle index, host s)]."""
        done, h0 = [], time.perf_counter()
        while not done or time.perf_counter() - h0 < s:
            done.append((prof.cycle + 1, time.perf_counter() - t0))
            tr.train_fused(n_train, log_every=10 ** 12, flush=False)
        return done

    t0 = time.perf_counter()
    h = time.perf_counter()
    while time.perf_counter() - h < plain_s:
        # each plain cycle's TRAIN device ms per grad step
        prof.reset()
        c, t = cycles(0.0)[0]
        prof.table()
        print(json.dumps({"cycle": c, "t_s": t, "plain_train_ms_per_step":
                          prof.totals["TRAIN"] * 1e3 / n_train}), flush=True)
    if plain_s:
        prof.trace()
    rows = []
    for c, t in cycles(seconds):
        sm = prof.summary(cycles=[c])
        train = [r for r in prof.records if r.cycle == c
                 and r.name == "TRAIN"]
        ph = sm["phases_ms"]
        row = {"cycle": c, "t_s": t, "step_ms": sm["step_ms"],
               "phases_ms": ph, "phase_sum_ms": sum(ph.values()),
               "train_ms_per_step": sum(r.dev1 - r.dev0 for r in train)
               / 1e6 / n_train,
               "presample_ms": sm["presample_ms"],
               "device_gap_share": sm["device_gap_share"]}
        row.update((k, sm[k]) for k in ("conv_macs", "conv_tflop_s",
                                        "bptt_cells", "bptt_macs",
                                        "bptt_cell_us") if k in sm)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if cuda:
        print(json.dumps({"phase_kernels": phase_kernels(tr)}), flush=True)

    # the cost of tracing: TRAIN ms per grad step in turns, and the
    # host's time per replay on an idle card
    i = tr._step_rows[1]
    prof.trace(False)
    cycles(0.0)                       # the plain step graph captured
    for traced in (False, True, True, False):
        prof.trace(traced)
        prof.reset()
        cycles(0.0)
        cycles(0.0)
        cycles(0.0)
        prof.table()
        per_step = prof.totals["TRAIN"] / prof.counts["TRAIN"] / n_train
        graph = tr._step_graphs[(True, "traced") if traced else True]
        if cuda:
            torch.cuda.synchronize()
        i.zero_()
        h0 = time.perf_counter_ns()
        for _ in range(64):
            if traced:
                span = prof.begin("STEP")
                graph()
                prof.end(span)
            else:
                graph()
        host_us = (time.perf_counter_ns() - h0) / 1e3 / 64
        print(json.dumps({"traced": traced,
                          "train_ms_per_step": per_step * 1e3,
                          "host_us_per_replay": host_us}), flush=True)
    prof.trace()
    prof.reset()
    cycles(0.0)
    info = {"mapping_error_us": prof.mapping_error_ns() / 1e3,
            "timer_ticks_ns": timer_ticks_ns(tr.device)[:16] if cuda
            else None,
            "graph_pool_bytes": tr.graph_pool_bytes(),
            "launches": kernel_launches(tr)}
    if out:
        prof.export_chrome_trace(out)
        info["trace"] = out
    print(json.dumps(info), flush=True)
    return rows


if __name__ == "__main__":
    main()

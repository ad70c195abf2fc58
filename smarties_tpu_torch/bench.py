"""Headline benchmark of the port: V-RACER on cart-pole, one CUDA card.

    python -m smarties_tpu_torch.bench [--device cuda] [--fused-cycles 10]
        [--seeds 0 1 2] [--quality-cycles 256] [--quality-wall-s S]
        [--budget-s 480]

The twin of the JAX package's bench.py, built from the port's own
pieces: the main path's trainer (runtime/profile_main.main_path_trainer:
1024 envs, 4096 slots x 501 steps, [128, 128], batch 256, obsPerStep 1,
minTotObsNum 16384; on a card its env sweep and grad step run as
captured CUDA graphs, runtime/graphs.py, as users run it), the Atari
setup and its FLOP count
(profile_main.atari_setup, step_flops) and the card's line
(runtime/bench_retrace.card_line). The phases run in order:

  fused     warmup(chunk=16, blind_sweeps=16), one untimed fused cycle,
            then --fused-cycles cycles (1 env sweep of 1024 envs + 1024
            grad steps each, the 1000-step refresh between cycles as
            train_fused runs it), timed by CUDA events with one
            synchronize at the end: combined env and grad steps/s and
            fused_cycle_ms over the whole window (bench.py's sense), and
            the per-cycle min / median / max.
  steady    64 rollout sweeps (the eager rollout without the ingest
            sweep, as bench.py's), then a train chunk of 500 steps (the
            step graph replayed); each run once untimed and once timed
            between synchronizes.
  atari     RACER-discrete over the Mnih stack (84x84x4, [512], batch
            128) on a uint8 replay of 512 x 129 random frames, 1024
            presampled grad steps, best of 2 timed runs. Its FLOPs count
            the conv and matmul multiply-adds of one step from the shapes
            (step_flops; torch has no compiled-module cost analysis as
            XLA does), so activations, biases and the optimiser are left
            out. The port computes in f32 with TF32 off, so the MFU is
            against the card's FP32 peak; the Adam floor is parameters x
            28 B over the card's HBM rate. A card missing from the peak
            tables gets null and the reason.
  quality   per seed, the JAX QualityDispatch: the trainer with
            minTotObsNum 65536 and 64 blind sweeps, then K cycles of one
            fused cycle and the refresh, the trailing-20 ring of noisy
            training returns folded on the device (at most 128
            completions a sweep; the rest counted as overflow), a
            noise-free evaluate(32) at the end, and one read of it all.
            --quality-wall-s stops a seed between cycles, and the seed's
            result says so ("cut_by_wall_s" and the grad steps reached).

K1's launches (ops/retrace_kernel.launches, counted from each phase's
start) and the peak memory of each phase go into the extras. --budget-s
gates the steady and Atari phases as bench.py's left() does. The printed
line is bench.py's schema ({"metric", "value", "unit", "vs_baseline",
"extras"}) within its 1800-character budget and shed order; vs_baseline
is null (bench.py's denominator is a TPU figure). The whole capture,
the per-seed curves included, goes to build/bench_torch_partial.json
after every phase; on SIGTERM the partial line is printed. bench.py's
TPU machinery (the compile-cache re-exec, the transfer canary, the
dispatch-all-then-read order) has no counterpart here.

--device defaults to "cuda" and raises where there is no card; the
tests pass "cpu" and cut sizes through `run`.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import signal
import statistics
import sys
import time
from typing import Callable, Optional

import torch

from smarties_tpu_torch.runtime.bench_retrace import HBM_BYTES_PER_S

THRESHOLD, TRAIL = 150.0, 20     # bench.py's quality gate
TOPK = 128                       # completions folded per 1-step sweep
QUALITY_MIN_OBS = 65536
LINE_BUDGET = 1800
# FP32 peak FLOP/s outside the tensor cores and HBM bytes/s, by the name
# torch.cuda.get_device_name gives (NVIDIA's data sheet, H100 SXM)
FP32_PEAKS = {"NVIDIA H100 80GB HBM3": 67e12}
HBM_RATES = {"NVIDIA H100 80GB HBM3": HBM_BYTES_PER_S}
ADAM_BYTES_PER_PARAM = 28        # read p, m, v, grad; write p, m, v (f32)
PARTIAL_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
    "bench_torch_partial.json")
SHED_ORDER = ("quality_detail", "curve_every_cycle", "timing",
              "peak_memory_gib", "final_trail_mean", "device", "errors")
CORE_KEYS = ("fused_cycle_ms", "episodes_to_threshold",
             "eval_mean_deterministic", "atari_mfu_vs_f32_peak", "wall_s")


@dataclasses.dataclass(frozen=True)
class Sizes:
    """The bench's sizes; the defaults are bench.py's."""
    n_envs: int = 1024
    n_slots: int = 4096
    fused_cycles: int = 10
    steady_sweeps: int = 64
    steady_steps: int = 500
    atari_slots: int = 512
    atari_steps: int = 1024
    quality_sweeps: int = 64           # QUALITY_MIN_OBS / 1024 envs
    eval_episodes: int = 32
    eval_steps: int = 1000


class _Terminated(Exception):
    """Raised in the main thread on SIGTERM: print the partial line."""


def _on_sigterm(signum, frame):
    raise _Terminated()


class Marks:
    """Time marks on the device's timeline: CUDA events on a card (read
    after one synchronize), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list:
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_s(fn, device: torch.device) -> float:
    """Host seconds of fn() between two synchronizes."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def fold(ring, count, done, ret, topk: int = TOPK, trail: int = TRAIL):
    """The trailing-`trail` ring of episode returns after one sweep, on
    the device with no host read: bench.py's QualityDispatch.fold pushed
    the sweep's completions one at a time, in lane order, at most `topk`
    of them, into ring[count % trail]. Only the last min(trail, m) of the
    m pushed completions survive, at distinct positions, so each ring
    position gathers the one that lands there last (or keeps its value).
    -> (ring, count + m, overflow = max(sum(done) - topk, 0))."""
    V = done.shape[0]
    k_max = min(topk, V)
    # completed lanes first, each group in lane order (a stable sort)
    order = torch.argsort((~done).to(torch.int32), stable=True)[:k_max]
    r = ret[order].to(ring.dtype)
    n = done.sum()
    m = torch.clamp(n, max=k_max)
    lo = torch.clamp(m - trail, min=0)
    pos = torch.arange(trail, device=ring.device)
    # the push index k >= lo with (count + k) % trail == position
    k = lo + torch.remainder(pos - count - lo, trail)
    hit = k < m
    new = torch.where(hit, r[torch.clamp(k, max=k_max - 1)], ring)
    return new, count + m, torch.clamp(n - topk, min=0)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def phase_fused(tr, n_cycles: int) -> dict:
    """One untimed fused cycle, then n_cycles timed by device marks with
    one synchronize at the end; the trainer's own train_fused runs each
    cycle (and the 1000-step refresh after it)."""
    def cycle():
        tr.train_fused(tr.n_envs, log_every=10 ** 9, flush=False)

    cycle()
    marks = Marks(tr.device)
    marks.mark()
    for _ in range(n_cycles):
        cycle()
        marks.mark()
    ms = marks.intervals_ms()
    window_s = sum(ms) / 1e3
    steps = n_cycles * tr.n_envs
    return {"combined_env_steps_per_s": round(steps / window_s, 1),
            "combined_grad_steps_per_s": round(steps / window_s, 1),
            "fused_cycle_ms": round(window_s * 1e3 / n_cycles, 2),
            "fused_cycle_ms_min": round(min(ms), 2),
            "fused_cycle_ms_median": round(statistics.median(ms), 2),
            "fused_cycle_ms_max": round(max(ms), 2),
            "fused_cycles": n_cycles}


def phase_steady(tr, sweeps: int, steps: int) -> dict:
    """bench.py's phase_steady: rollout sweeps alone (no ingest sweep, as
    its jitted rollout), then a train chunk; each once untimed, once
    timed."""
    def roll():
        tr.carry, _ = tr._rollout(tr.params, tr.carry, sweeps)

    def train():
        tr._train_chunk(steps)

    roll()
    dt_roll = _timed_s(roll, tr.device)
    train()
    dt_train = _timed_s(train, tr.device)
    tr._pending_logs.clear()
    return {"rollout_env_steps_per_s": round(sweeps * tr.n_envs / dt_roll,
                                             1),
            "train_chunk_grad_steps_per_s": round(steps / dt_train, 1)}


def phase_atari(device: torch.device, n_slots: int, q: int) -> dict:
    """bench.py's build_atari and time_atari: q presampled grad steps of
    the conv learner, one untimed run and the best of 2 timed ones."""
    from smarties_tpu_torch.algos.base import presample_uniform
    from smarties_tpu_torch.models.net import tree_leaves
    from smarties_tpu_torch.runtime.profile_main import (atari_setup,
                                                         step_flops)
    algo, params, opt, rs = atari_setup(device, seed=0, n_slots=n_slots)
    B = algo.cfg.batchSize
    eps, ts = presample_uniform(
        torch.Generator(device=device).manual_seed(2), rs, B, q)
    state = [params, opt, rs]

    def chunk():
        p, o, r = state
        for i in range(q):
            p, o, r, _ = algo.train_step(p, o, r,
                                         sample_override=(eps[i], ts[i]))
        state[:] = [p, o, r]

    chunk()
    best = min(_timed_s(chunk, device) for _ in range(2))
    step_ms = best * 1e3 / q
    # [s_t; s_t1] go forward together, and back (profile_main.py)
    flops = step_flops(algo.spec, 2 * B, 2 * B)
    tflops = flops / (step_ms * 1e-3) / 1e12
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    res = {"atari_train_step_ms": round(step_ms, 3),
           "atari_grad_steps_per_s": round(q / best, 1),
           "atari_flops_per_step_g": round(flops / 1e9, 3),
           "atari_tflops_achieved": round(tflops, 3)}
    peak, hbm = FP32_PEAKS.get(name), HBM_RATES.get(name)
    res["atari_mfu_vs_f32_peak"] = (round(tflops * 1e12 / peak, 4)
                                    if peak else None)
    n_par = sum(x.numel() for x in tree_leaves(state[0]))
    if hbm:
        floor_ms = n_par * ADAM_BYTES_PER_PARAM / hbm * 1e3
        res["atari_adam_hbm_floor_ms"] = round(floor_ms, 3)
        res["atari_adam_hbm_floor_frac"] = round(floor_ms / step_ms, 3)
    else:
        res["atari_adam_hbm_floor_ms"] = None
        res["atari_adam_hbm_floor_frac"] = None
    if not (peak and hbm):
        res["atari_peak_note"] = f"no FP32 peak or HBM rate known for {name!r}"
    return res


def quality_seed(seed: int, sizes: Sizes, cycles: int, device,
                 wall_s: Optional[float] = None,
                 hook: Optional[Callable] = None) -> dict:
    """bench.py's QualityDispatch for one seed: training with the ring
    folded on the device every cycle, the noise-free eval, and one read
    of everything at the end -> finish()'s keys. The wall limit is read
    between cycles from the host clock (no device read)."""
    from smarties_tpu_torch.runtime.profile_main import main_path_trainer
    tr = main_path_trainer(seed, device, sizes.n_envs, sizes.n_slots)
    tr.cfg.minTotObsNum = tr.n_obs_b4_start = QUALITY_MIN_OBS
    if hook is not None:
        hook(tr)
    tr.warmup(chunk=16, blind_sweeps=sizes.quality_sweeps)
    n_train = tr.n_envs                  # obsPerStep 1
    ring = torch.zeros(TRAIL, device=tr.device)
    count = torch.zeros((), dtype=torch.int64, device=tr.device)
    cnts, means, ovfs = [], [], []
    t0 = time.time()
    cut = False
    for i in range(cycles):
        if wall_s is not None and time.time() - t0 >= wall_s:
            cut = True
            break
        _, logs = tr._fused_cycle(1, n_train)
        ring, count, ovf = fold(ring, count, logs[0].reshape(-1),
                                logs[2].reshape(-1))
        # the reference's every-1000-grad-steps refresh, once a cycle
        tr._update_replay(tr._refresh, float((i + 1) * n_train))
        cnts.append(count)
        means.append(ring.mean())
        ovfs.append(ovf)
    done_cycles = len(cnts)
    ev = tr.evaluate(sizes.eval_episodes, sizes.eval_steps,
                     materialize=False)
    tr._pending_logs.clear()
    # read back after the run, never inside it
    if done_cycles:
        cnts = torch.stack(cnts).tolist()
        means = torch.stack(means).tolist()
        overflow = int(torch.stack(ovfs).sum())
    else:
        cnts, means, overflow = [], [], 0
    ev = ev.cpu()
    ok = [c >= TRAIL and m >= THRESHOLD for c, m in zip(cnts, means)]
    res = {"seed": seed,
           "episodes_to_threshold": cnts[ok.index(True)] if any(ok) else None,
           "episodes_total": cnts[-1] if cnts else 0,
           "grad_steps": done_cycles * n_train,
           "env_steps": done_cycles * tr.n_envs,
           "final_trail_mean": (round(means[-1], 1)
                                if cnts and cnts[-1] >= TRAIL else None),
           "noisy_return_ceiling": round(max(means), 1) if means else None,
           "tracker_overflow_episodes": overflow,
           "curve_every_cycle": [[c, round(m, 1)]
                                 for c, m in zip(cnts[::16], means[::16])],
           "cycles": done_cycles, "cut_by_wall_s": cut}
    if torch.isfinite(ev).all():
        res["eval_mean_deterministic"] = round(float(ev.mean()), 1)
    else:
        res["eval_nonfinite"] = True
    return res


# ----------------------------------------------------------------------
# the run and its line
# ----------------------------------------------------------------------

def _fit_line(doc: dict) -> str:
    """bench.py's line budget: shed optional extras in its order until
    the line fits, then keep only the core scalars."""
    extras = doc["extras"]
    line = json.dumps(doc)
    for key in SHED_ORDER:
        if len(line) <= LINE_BUDGET:
            break
        if key in extras:
            del extras[key]
            line = json.dumps(doc)
    if len(line) > LINE_BUDGET:
        doc["extras"] = {k: extras[k] for k in CORE_KEYS if k in extras}
        line = json.dumps(doc)
    return line


def run(sizes: Sizes = Sizes(), seeds=(0, 1, 2), quality_cycles: int = 256,
        quality_wall_s: Optional[float] = None, budget_s: float = 480.0,
        device="cuda", partial_path: str = PARTIAL_PATH,
        hook: Optional[Callable] = None):
    """Every phase in order -> (the printed line, the errors; the line
    may have shed them). hook(trainer, phase),
    when given, sees each trainer before its warmup ("fused" for the
    fused and steady phases' trainer, "quality<seed>")."""
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.bench_retrace import card_line
    from smarties_tpu_torch.runtime.profile_main import main_path_trainer
    from smarties_tpu_torch.runtime.trainer import checked_device
    dev = checked_device(device)
    t_start = time.time()

    def left():
        return budget_s - (time.time() - t_start)

    extras = {"n_envs": sizes.n_envs, "batch_size": 256,
              "timing": "fused: CUDA events, one synchronize per window; "
                        "steady, atari: host clock between synchronizes",
              "device": card_line() if dev.type == "cuda" else "cpu"}
    k1, peaks, k1_start = {}, {}, {}
    extras["k1_launches"], extras["peak_memory_gib"] = k1, peaks
    errors, skipped, quality = [], [], []
    state = {"value": 0.0}

    def flush_partial(stage):
        doc = {"stage": stage, "value": state["value"], "extras": extras,
               "quality_detail": quality, "errors": errors,
               "skipped_for_budget": skipped,
               "wall_s": round(time.time() - t_start, 1)}
        os.makedirs(os.path.dirname(partial_path), exist_ok=True)
        tmp = partial_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, partial_path)

    def begin(phase):
        k1_start[phase] = sum(rk.launches.values())
        gc.collect()                     # the last phase's trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    def end(phase):
        k1[phase] = sum(rk.launches.values()) - k1_start[phase]
        if dev.type == "cuda":
            peaks[phase] = round(torch.cuda.max_memory_allocated(dev)
                                 / 2 ** 30, 3)
        flush_partial(phase)

    tr = None
    try:
        begin("fused")
        try:
            t0 = time.perf_counter()
            if dev.type == "cuda":
                rk.library()             # K1's build, part of the set-up
            tr = main_path_trainer(0, dev, sizes.n_envs, sizes.n_slots)
            if hook is not None:
                hook(tr, "fused")
            tr.warmup(chunk=16, blind_sweeps=16)
            _sync(dev)
            extras["setup_s"] = round(time.perf_counter() - t0, 2)
            extras.update(phase_fused(tr, sizes.fused_cycles))
            state["value"] = extras["combined_env_steps_per_s"]
        except _Terminated:
            raise
        except Exception as e:
            errors.append(f"fused: {e!r}"[:300])
        end("fused")
        if tr is not None and left() > 25:
            begin("steady")
            try:
                extras.update(phase_steady(tr, sizes.steady_sweeps,
                                           sizes.steady_steps))
            except _Terminated:
                raise
            except Exception as e:
                errors.append(f"steady: {e!r}"[:300])
            end("steady")
        else:
            skipped.append("steady")
        tr = None                        # free the main path's replay
        if left() > 15:
            begin("atari")
            try:
                extras.update(phase_atari(dev, sizes.atari_slots,
                                          sizes.atari_steps))
            except _Terminated:
                raise
            except Exception as e:
                errors.append(f"atari: {e!r}"[:300])
            end("atari")
        else:
            skipped.append("atari")
        for seed in seeds:
            phase = f"quality{seed}"
            begin(phase)
            try:
                quality.append(quality_seed(
                    seed, sizes, quality_cycles, dev, quality_wall_s,
                    None if hook is None else (lambda t: hook(t, phase))))
            except _Terminated:
                raise
            except Exception as e:
                errors.append(f"{phase}: {e!r}"[:300])
            end(phase)
    except _Terminated:
        errors.append("terminated before completion (partial capture)")

    if quality:
        vals = [q["episodes_to_threshold"] for q in quality]
        ok = sorted(v for v in vals if v is not None)
        extras["quality_seeds"] = [q["seed"] for q in quality]
        extras["quality_cycles"] = quality_cycles
        extras["episodes_to_threshold"] = vals
        extras["episodes_to_threshold_median"] = (ok[len(ok) // 2]
                                                  if ok else None)
        extras["eval_mean_deterministic"] = [
            q.get("eval_mean_deterministic") for q in quality]
        extras["final_trail_mean"] = [q["final_trail_mean"]
                                      for q in quality]
        extras["quality_grad_steps"] = [q["grad_steps"] for q in quality]
        extras["cut_by_wall_s"] = [q["cut_by_wall_s"] for q in quality]
        extras["tracker_overflow_episodes"] = [
            q["tracker_overflow_episodes"] for q in quality]
    extras["wall_s"] = round(time.time() - t_start, 1)
    extras["errors"] = errors
    extras["skipped_for_budget"] = skipped
    flush_partial("done")
    return _fit_line({"metric": "combined_env_steps_per_s",
                      "value": state["value"], "unit": "env-steps/s/card",
                      "vs_baseline": None, "extras": extras}), errors


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m smarties_tpu_torch.bench")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    p.add_argument("--fused-cycles", type=int, default=Sizes.fused_cycles,
                   help="timed fused cycles (after one untimed)")
    p.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2],
                   help="quality seeds (none: no quality phase)")
    p.add_argument("--quality-cycles", type=int, default=256,
                   help="fused cycles of 1024 grad steps per seed")
    p.add_argument("--quality-wall-s", type=float, default=None,
                   help="stop each seed between cycles after this many "
                        "seconds (reported as cut_by_wall_s)")
    p.add_argument("--budget-s", type=float, default=480.0,
                   help="the steady and Atari phases run only while this "
                        "much of the run's time is left (bench.py's "
                        "BENCH_BUDGET_S)")
    args = p.parse_args(argv)
    signal.signal(signal.SIGTERM, _on_sigterm)
    line, errors = run(Sizes(fused_cycles=args.fused_cycles),
                       tuple(args.seeds), args.quality_cycles,
                       args.quality_wall_s, args.budget_s, args.device)
    print(line, flush=True)
    if errors:
        sys.exit(1)


if __name__ == "__main__":
    main()

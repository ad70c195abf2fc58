"""Driver of the training mixes: the port's Trainer in its fused
actor-learner cycle (Trainer.train_fused: one env sweep of every env,
with its commit and K1's at-ingest Retrace, captured as one CUDA graph;
n_envs / obsPerStep grad steps, each a replay of the captured step; the
1000-step refresh between cycles), as users train with it.

Set-up (setup_s): imports, K1's library, the Trainer, the benchmark's
weights written into it, the warmup with initialize_stats
(Trainer.warmup; with the configuration's fill_env_steps, that many env
steps of one-sweep chunks, so that the window finds the replay as a long
run holds it), the checks' readings below, and one untimed cycle. The window then runs
whole cycles until --seconds have passed on the host clock and is timed
by CUDA events from its first cycle's start to the end of its last:
grad_steps_per_s is all its grad steps over all that time.

What decides `correct` (the references run after the window, once the
peak memory is read and the trainer is freed):
- stats: initialize_stats's state and reward statistics against the
  exact moments of the replay (computed in set-up, where the replay is
  still the one they were taken of; their time is left out of
  setup_s);
- env: stored episodes against the env's dynamics (the reference's own
  step from each stored state and action), 64 slots of the warmup's and
  every episode the checked sweep committed;
- retrace: Qret of 128 slots after initialize_stats (K1 over every
  slot) and of the checked sweep's new episodes (K1 at ingest, inside
  the captured sweep), against the Retrace recursion in float64;
- loss, grad, change: the first three grad steps of the captured step,
  from the benchmark's second set of weights and a fresh optimiser
  written into the trainer after the step graph's two warm-up calls,
  on the presampled rows they drew: the rms TD error of each step, the
  first step's batch-mean gradient per leaf (Adam's first moment after
  one step over 1 - beta1) and each leaf's change after three steps,
  against the reference's steps in float64 from the same replay rows.
  The replay rows, the statistics and the ReF-ER scalars at the start
  of the steps are the program's own state, followed as it stands; its
  start is what stats, env and retrace check.
"""
from __future__ import annotations

import gc
import statistics
import sys
import time

import numpy as np
import torch

from benchmark import trace as btrace
from benchmark import yardstick
from benchmark.drivers import program
from benchmark.reference import nets, racer, retrace, sampling, stats

N_INIT_SLOTS = 128
N_ENV_SLOTS = 64
N_STEPS = 3


def _np(x):
    return x.detach().cpu().numpy()


def _columns(rs, slots):
    """Stored episodes of `slots` (a device index tensor), as numpy."""
    return {"states": _np(rs.states_tm[:, slots].transpose(0, 1)),
            "actions": _np(rs.actions_tm[:, slots].transpose(0, 1)
                           ).astype(np.float64),
            "rewards": _np(rs.rewards_tm[:, slots].t()).astype(np.float64),
            "value": _np(rs.value_tm[:, slots].t()).astype(np.float64),
            "adv": _np(rs.advantage_tm[:, slots].t()).astype(np.float64),
            "rho": _np(rs.rho_tm[:, slots].t()).astype(np.float64),
            "qret": _np(rs.qret_tm[:, slots].t()).astype(np.float64),
            "v_trunc": _np(rs.v_trunc[slots]).astype(np.float64),
            "length": _np(rs.slot_len[slots]),
            "terminal": _np(rs.slot_term[slots]),
            "rew_mean": float(rs.rew_mean), "rew_scale": float(rs.rew_scale)}


def _written_rho(rs, ep, t):
    """The importance weights a grad step wrote back at its rows."""
    return rs.rho_tm[t.long(), ep.long()].clone()


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Setup:
    """The trainer through its set-up, with the readings the checks
    need."""

    def __init__(self, files, ref, seed, options):
        conf = {**files["config"], **options.get("sizes", {})}
        self.settings = program.settings(files, options.get("sizes"))
        self.arch = ref.arch({**conf, "settings": self.settings})
        self.conf = conf
        dev = torch.device(options.get("device", "cuda"))
        self.excluded = 0.0
        if dev.type == "cuda":
            from smarties_tpu_torch.ops import retrace_kernel as rk
            rk.library()
        tr = self.tr = program.build_trainer(files, seed, dev,
                                             options.get("sizes"),
                                             options.get("graphs"))
        self.dev = tr.device
        self.n_train = max(1, int(round(tr.n_envs / tr.cfg.obsPerStep)))
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        pinit = ref.param_init({**conf, "settings": self.settings})
        draw = getattr(ref, "draw_weights", nets.draw_weights)
        w_act = draw(gen, self.arch, pinit, self.dev)
        self.w1 = draw(gen, self.arch, pinit, self.dev)
        self.ref = ref
        program.write_weights(tr.params, w_act, ref)
        if conf.get("fill_env_steps"):
            # one-sweep chunks: the fused cycle's own sweep graph
            tr.warmup(chunk=1, blind_sweeps=-(-conf["fill_env_steps"]
                                              // tr.n_envs))
        else:
            tr.warmup()
        rs = tr.replay
        self.snap = {"seed": seed}
        t0 = time.perf_counter()
        self.snap["stats"] = self._stats(rs)
        self.excluded += time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        valid = torch.nonzero(rs.slot_id >= 0)[:, 0].cpu().numpy()
        pick = np.sort(rng.choice(valid, min(N_INIT_SLOTS, valid.size),
                                  replace=False))
        self.snap["init_cols"] = _columns(
            rs, torch.as_tensor(pick, device=self.dev))
        # the step graph's two eager warm-up calls; the sweep graph was
        # captured in the warmup's one-sweep chunks (its third)
        for _ in range(2):
            tr._train_chunk(1)
            tr.n_grad_steps += 1
        sid = rs.slot_id.clone()
        tr._sweep(1)
        tr.n_env_steps += tr.n_envs
        new = torch.nonzero((rs.slot_id != sid) & (rs.slot_id >= 0))[:, 0]
        self.snap["ingest_cols"] = _columns(rs, new)
        self._steps()
        tr.train_fused(tr.n_envs, log_every=10 ** 12, flush=False)
        _sync(self.dev)

    def _drawing_steps(self):
        """The checked steps of a step graph that draws its own minibatch
        (the prioritized samplers): before each, the program's draw is
        made again eagerly from a copy of its generator's state (the
        same function on the same replay and state), and the uniforms
        it draws are read from another copy; the reference judges the
        draw and follows the step on it."""
        from smarties_tpu_torch.replay import buffer as rb
        tr, dev = self.tr, self.dev
        rs = tr.replay
        B, algo = tr.cfg.batchSize, tr.cfg.dataSamplingAlgo
        draw = {"delta": [], "valid0": rs.valid_steps_tm().clone(), "u": [],
                "flat": []}
        idx, losses, g1, rho1 = [], [], None, None
        L1 = rs.states_tm.shape[0]
        for k in range(N_STEPS):
            draw["delta"].append(rs.delta_tm.clone())
            state = tr.gen_batch.get_state()
            g = torch.Generator(device=dev)
            g.set_state(state)
            ep, t = rb.sample(g, rs, B, algo)
            g.set_state(state)
            draw["u"].append(torch.rand((B,), generator=g,
                                        dtype=torch.float32, device=dev))
            draw["flat"].append(ep.long() * L1 + t.long())
            idx.append((ep.clone(), t.clone()))
            m = tr._train_chunk(1)
            losses.append(float(m["rmse"][0]))
            if k == 0:
                g1 = program.read_tree(tr.opt_state.m1, self.ref, 1 / 0.1)
                rho1 = _written_rho(rs, ep, t)
        return idx, losses, g1, rho1, draw

    def _stats(self, rs):
        ref = stats.moments(rs.states_tm, rs.rewards_tm, rs.slot_len,
                            rs.slot_id)
        prog = {"state_mean": rs.state_mean, "state_std": rs.state_std,
                "rew_mean": rs.rew_mean, "rew_std": rs.rew_std}
        return {k: (_np(prog[k]).astype(np.float64), _np(ref[k]))
                for k in ref}

    def _steps(self):
        """The three checked grad steps and what the reference needs."""
        tr, arch, dev = self.tr, self.arch, self.dev
        rs = tr.replay
        program.write_weights(tr.params, self.w1, self.ref)
        program.reset_adam(tr.opt_state)
        rho0 = rs.rho_tm.clone()
        sc0 = {"beta": rs.beta.clone(), "alpha": rs.alpha.clone(),
               "cmax": rs.cmax_ret.clone(),
               "n_stored": float(rs.n_stored_steps()),
               "n_far": float(rs.far_count.sum())}
        mean, scale = rs.state_mean.clone(), rs.state_scale.clone()
        if tr._can_presample:
            m1 = tr._train_chunk(1)
            pins = tr._step_rows[3]
            idx = [(pins[0][0].clone(), pins[1][0].clone())]
            g1 = program.read_tree(tr.opt_state.m1, self.ref, 1 / 0.1)
            rho1 = _written_rho(rs, *idx[0])
            m23 = tr._train_chunk(2)
            idx += [(pins[0][k].clone(), pins[1][k].clone())
                    for k in range(2)]
            losses = [float(m1["rmse"][0])] + [float(x) for x in m23["rmse"]]
        else:
            idx, losses, g1, rho1, draw = self._drawing_steps()
            self.snap["draw"] = draw
        tr.n_grad_steps += N_STEPS
        p3 = program.read_tree(tr.params, self.ref)
        k_app = tr.mdp.n_appended_obs
        L1 = rs.states_tm.shape[0]
        batches = []
        for ep, t in idx:
            ep, t = ep.long(), t.long()
            rows = torch.clamp(t[:, None] - torch.arange(
                k_app + 1, device=dev)[None, :], min=0)
            batches.append({
                "frames": rs.states_tm[rows, ep[:, None]].clone(),
                "action": rs.actions_tm[t, ep].clone(),
                "mu": rs.mus_tm[t, ep].clone(),
                "qret": rs.qret_tm[t, ep].clone(),
                "valid": (rs.slot_id[ep] >= 0) & (t < rs.slot_len[ep]),
                "rho_old": rho0[t, ep].clone(),
                "key": (ep * L1 + t).cpu()})
        self.snap["steps"] = {
            "batches": batches, "sc0": sc0, "mean": mean, "scale": scale,
            "w1": {k: v.clone() for k, v in self.w1.items()},
            "prog": {"losses": losses, "grad": g1, "w3": p3, "rho": rho1}}


# ----------------------------------------------------------------------
# the checks
# ----------------------------------------------------------------------

def reference_steps(snap, ref, arch, settings, dtype, tf32, half=False):
    """The reference's grad steps from the snapshot -> (steps, weights)."""
    st = snap["steps"]
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        batches = []
        for b in st["batches"]:
            n = b["qret"].shape[0] // 2 if half else b["qret"].shape[0]
            mb = {"x": ref.net_input(b["frames"][:n], st["mean"].to(dtype),
                                     st["scale"].to(dtype)),
                  "action": (b["action"][:n, 0] if ref.KIND == "discrete"
                             else b["action"][:n].to(dtype)),
                  "mu": b["mu"][:n].to(dtype), "qret": b["qret"][:n].to(dtype),
                  "valid": b["valid"][:n], "rho_old": b["rho_old"][:n].to(dtype),
                  "key": b["key"][:n]}
            mb.update(ref.batch_extras(mb))
            batches.append(mb)
        sc0 = dict(st["sc0"])
        for k in ("beta", "alpha", "cmax"):
            sc0[k] = sc0[k].to(dtype)
        w1 = {k: v.to(dtype) for k, v in st["w1"].items()}
        steps, w3 = racer.grad_steps(
            w1, batches, sc0, settings, ref.KIND, ref.N_ACT,
            lambda w, x: ref.forward(w, arch, x))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    return {"losses": [s["loss"] for s in steps],
            "scales": [max(s["loss"], s["qret_rms"]) for s in steps],
            "grad": steps[0]["grad"], "rho": steps[0]["rho"],
            "valid": st["batches"][0]["valid"],
            "w3": w3}


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def step_gaps(side, ref_side, w1) -> dict:
    """loss: the largest gap of a step's rms TD error, over the larger of
    the reference's rms TD error and rms Qret of the batch (the TD error
    is a difference of the two, and cancels); grad and
    change: the worst leaf's gap between the two sides' norms of the
    first step's gradient and of the change after three steps, over the
    larger of the reference's norm of that leaf and of the median leaf.
    change leaves out leaves whose reference gradient is under 1e-3 of
    the median leaf's (moved by round-off alone). rho: the largest
    relative gap of an importance weight pi / mu that the first step
    wrote back at its (valid) rows, one number per row and not a norm,
    so that rounding in the forward pass shows."""
    loss = max(abs(a - b) / s for a, b, s in
               zip(side["losses"], ref_side["losses"], ref_side["scales"]))
    gr = {k: _norm(v) for k, v in ref_side["grad"].items()}
    gmed = max(statistics.median(gr.values()), 1e-30)
    grad = max(abs(_norm(side["grad"][k]) - gr[k]) / max(gr[k], gmed)
               for k in gr)
    moved = [k for k in gr if gr[k] >= 1e-3 * gmed]
    dr = {k: _norm(ref_side["w3"][k] - w1[k].to(ref_side["w3"][k].dtype))
          for k in moved}
    if not dr:
        return {"loss": loss, "grad": grad, "change": float("inf"),
                "rho": float("inf")}
    dmed = max(statistics.median(dr.values()), 1e-30)
    change = max(abs(_norm(side["w3"][k].double() - w1[k].double())
                     - dr[k]) / max(dr[k], dmed) for k in moved)
    n = side["rho"].shape[0]        # the half-batch fault's is shorter
    valid = ref_side["valid"][:n]
    rr = ref_side["rho"][:n].double()[valid]
    rho = float(torch.max(torch.abs(side["rho"].double()[valid] - rr) / rr))
    return {"loss": loss, "grad": grad, "change": change, "rho": rho}


def start_gaps(snap, ref, settings) -> dict:
    """stats: the largest gap of the start's statistics, over each
    field's largest magnitude; the env's numbers (ref.ENV_GAP: the
    largest state gap, or mismatched pixels; env_events: wrong rewards
    and ends); retrace: the largest Qret gap over the largest |Qret| of
    the slot set."""
    st = {k: float(np.max(np.abs(p - r)) / max(np.max(np.abs(r)), 1e-30))
          for k, (p, r) in snap["stats"].items()}
    a, b = snap["init_cols"], snap["ingest_cols"]
    k = min(N_ENV_SLOTS, a["length"].size)
    env = {key: np.concatenate([a[key][:k], b[key]])
           for key in ("states", "actions", "rewards", "length", "terminal")}
    env_gap, env_wrong = ref.env_gaps(env)
    q_gap = 0.0
    for c in (a, b):
        if c["length"].size == 0:
            continue
        v = c["value"].copy()
        v[np.arange(v.shape[0]), c["length"]] = c["v_trunc"]
        q = retrace.retrace_rows(c["rewards"], v, c["adv"], c["rho"],
                                 c["length"], c["terminal"], c["rew_mean"],
                                 c["rew_scale"], settings["gamma"],
                                 settings["lambda"])
        upto = np.arange(q.shape[1])[None, :] <= c["length"][:, None]
        scale = max(float(np.max(np.abs(q))), 1e-30)
        q_gap = max(q_gap, float(np.max(np.abs(
            np.where(upto, c["qret"], 0.0) - q))) / scale)
    return {"stats": max(st.values()), ref.ENV_GAP: float(env_gap),
            "env_events": float(env_wrong), "retrace": q_gap}


def draw_gap(snap) -> dict:
    """draw: how far the largest of a checked step's uniforms lies
    outside the cumulative-probability interval of the step the program
    drew with it, under the reference's rank-based priorities of the
    replay's TD errors as they stood before that step. The ranks follow
    the program's own errors: the reference's errors of the rows that a
    step wrote differ from the program's by the float32 rounding of V
    (see the loss check, which holds them), and a rank order is not
    stable under that."""
    d = snap["draw"]
    valid = _np(d["valid0"].t()).reshape(-1)
    gap = 0.0
    for delta, u, flat in zip(d["delta"], d["u"], d["flat"]):
        err = np.abs(_np(delta.t()).astype(np.float64)).reshape(-1)
        cdf = sampling.per_rank_cdf(err, valid)
        gap = max(gap, float(sampling.draw_gaps(
            cdf, _np(flat), _np(u).astype(np.float64)).max()))
    return {"draw": gap}


def check(snap, ref, arch, settings) -> dict:
    """Every number compared for `correct`: the program against the
    reference (float64)."""
    ref64 = reference_steps(snap, ref, arch, settings, torch.float64, False)
    out = {**start_gaps(snap, ref, settings),
           **step_gaps(snap["steps"]["prog"], ref64, snap["steps"]["w1"])}
    if "draw" in snap:
        out.update(draw_gap(snap))
    return out


def control(snap, ref, arch, settings) -> dict:
    """The readings that set the limits: the program's numbers, the
    control's (the reference in float32 with TF32 on, in the program's
    place) and the half-batch fault's (the reference in float32 on the
    first half of each batch, the mean taken over it)."""
    ref64 = reference_steps(snap, ref, arch, settings, torch.float64, False)
    w1 = snap["steps"]["w1"]
    out = {"program": {**start_gaps(snap, ref, settings),
                       **step_gaps(snap["steps"]["prog"], ref64, w1)}}
    if "draw" in snap:
        out["program"].update(draw_gap(snap))
    for name, kw in (("tf32", {"tf32": True}),
                     ("half_batch", {"tf32": False, "half": True})):
        side = reference_steps(snap, ref, arch, settings, torch.float32,
                               **kw)
        out[name] = step_gaps(side, ref64, w1)
    return out


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------

class K1Bytes:
    """Bytes of each K1 call in the traced cycle, from the slots each
    sweep committed (slot ids before and after the captured sweep) and
    the slots each refresh swept (every valid one), read after it."""

    def __init__(self, tr, mode):
        self.tr, self.mode, self.calls = tr, mode, []
        sweep, refresh = tr._sweep, tr._refresh

        def wrapped_sweep(n):
            before = tr.replay.slot_id.clone()
            logs = sweep(n)
            rs = tr.replay
            self.calls.append((rs.slot_len.clone(),
                               (rs.slot_id != before) & (rs.slot_id >= 0),
                               False))
            return logs

        def wrapped_refresh(r, n):
            self.calls.append((r.slot_len.clone(), r.slot_id >= 0, True))
            return refresh(r, n)

        tr._sweep, tr._refresh = wrapped_sweep, wrapped_refresh

    def total(self) -> int:
        L1 = self.tr.replay.states_tm.shape[0]
        return sum(yardstick.k1_sweep_bytes(self.mode, L1, _np(lens),
                                            _np(sel), zero)
                   for lens, sel, zero in self.calls)


def run(files, ref, seed, seconds, trace, options, t_start) -> dict:
    s = Setup(files, ref, seed, options)
    tr, dev = s.tr, s.dev
    # untimed cycles for the mix's warm_s: a process's captured steps run
    # 12-20% slower for its first seconds on the card (PERF.md, section 7)
    warm_s = options.get("warm_s", files["mix"].get("warm_s", 0))
    h = time.perf_counter()
    while time.perf_counter() - h < warm_s:
        tr.train_fused(tr.n_envs, log_every=10 ** 12, flush=False)
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
    # n_in: the dense layers' input width
    conv = s.arch.get("conv", [])
    sizes = [s.arch["n_in"]] + list(s.arch["hidden"]) + [s.arch["n_out"]]
    B = tr.cfg.batchSize
    ctx = {"spans": spans, "grad_steps": grad_steps, "window_s": window_s,
           # [s_t; s_t1] go forward together, and back
           "flops_per_step": yardstick.step_flops(conv, sizes, 2 * B, 2 * B),
           "peaks": yardstick.peaks(name)}
    out = {"end_to_end": {"grad_steps_per_s": grad_steps / window_s,
                          "setup_s": setup_s},
           "attempted": grad_steps, "failed": 0, "device": device}
    if trace and cuda:
        k1 = K1Bytes(tr, tr.algo.returns_mode)
        reading = btrace.profile(
            lambda: tr.train_fused(tr.n_envs, log_every=10 ** 12,
                                   flush=False))
        ctx["trace"] = reading
        ctx["k1_bytes"] = k1.total()
        device["busy_s"] = btrace.busy_us(reading) / 1e6
        device["window_s"] = btrace.window_us(reading) / 1e6
        out["breakdown"] = btrace.breakdown(reading)
    snap, arch = s.snap, s.arch
    del s, tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["numbers"] = check(snap, ref, arch,
                           program.settings(files, options.get("sizes")))
    out["ctx"] = ctx
    return out


"""Driver of the fused mix over a truncated-BPTT window (mix fused_bptt):
train_fused's fused cycle, set-up, window, CUPTI reading and checks, and
train_phases' traced phases, for a recurrent V-RACER (the configuration
racer_rnn_cartpole: an LSTM on the no-velocity cart-pole). What differs
from train_fused, and why:

- the trainer: the env is a class inside its module ("cartpole.pomdp"),
  and the captured cycle is asked for (graphs=True), so that a program
  without a captured recurrent step stops at once, before its set-up,
  instead of running the eager loops;
- the leaves: an LSTM layer's gates, named lstm<i>.<leaf> as
  benchmark/reference/lstm.py names them (`program_leaves`);
- the checked steps: each row's window [t-W+1, t+1] of stored states is
  gathered for the reference, each position's active flag (t' >= 0) as
  the last column (`window_batch`);
- env: the stored states hide the velocities, so their rewards and ends
  are held to the observed x and angle (the reference's env_gaps), and
  the dynamics to the program's full lane states before and after the
  checked sweep, one step of each lane that did not end in it
  (lane_gaps); env_state is the larger of the two state gaps;
- mu: the reference's LSTM acts over 64 stored warmup episodes, each
  from a zero carry, under the weights and the replay's statistics they
  were acted with, and gives the stored behaviour policy at every step
  (behaviour_gap): the captured sweep's acting carry, threaded, held and
  zeroed where an episode ends;
- FLOPs: benchmark/bptt_flops.py's count of the window, for train.mfu.

On --trace 1 the CUPTI reading (busy_s, window_s, breakdown) is of one
sweep and TRACED_STEPS grad steps, not of a whole cycle: a cycle's 1024
steps are 3.2 M kernels, whose trace took the profiler minutes of host
work (about 7 min a run on an NVIDIA H100 80GB HBM3). After it come the
traced step's phases (Profiler.summary: the median ms of gather,
bptt_forward, head, bptt_backward, adam and writeback of a replay, and
the window's cell applications bptt_cells), read by train.step_bptt_ms
and train.bptt_cell_us.
"""
from __future__ import annotations

import gc
import importlib
import sys
import time

import numpy as np
import torch

from benchmark import bptt_flops
from benchmark import trace as btrace
from benchmark import yardstick
from benchmark.drivers import program, train_fused, train_phases
from benchmark.harness import RunError

N_STEPS = train_fused.N_STEPS
TRACED_STEPS = 128
N_INIT_SLOTS = train_fused.N_INIT_SLOTS
N_ENV_SLOTS = train_fused.N_ENV_SLOTS


def build_trainer(files: dict, seed: int, device, sizes=None, graphs=True):
    """The port's Trainer of the configuration; env "module.Class" names a
    class inside the env module. A program with no captured step for
    the configuration raises RunError."""
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters
    conf = {**files["config"], **(sizes or {})}
    module, _, attr = conf["env"].partition(".")
    env = importlib.import_module("smarties_tpu_torch.envs." + module)
    env = getattr(env, attr) if attr else env
    cfg = HyperParameters.from_dict({**program.settings(files, sizes),
                                     "randSeed": seed})
    try:
        return Trainer(env, env.MDP, cfg, n_envs=conf["n_envs"],
                       n_slots=conf["n_slots"], max_len=conf["max_len"],
                       device=device,
                       state_dtype=getattr(torch, conf["state_dtype"]),
                       graphs=graphs)
    except ValueError as e:
        if "no captured step" in str(e):
            raise RunError(f"the program cannot capture this "
                           f"configuration's grad step: {e}") from None
        raise


def program_leaves(params) -> dict:
    """{reference name: program leaf} of a recurrent net: lstm<i>.<leaf>
    of each layer, the output layer and the stdev head."""
    out = {}
    for i, layer in enumerate(params["layers"]):
        for k in sorted(layer):
            out[f"lstm{i}.{k}"] = layer[k]
    out["out.W"], out["out.b"] = params["out"]["W"], params["out"]["b"]
    if "param" in params:
        out["param"] = params["param"]
    return out


@torch.no_grad()
def write_weights(params, w: dict):
    for name, leaf in program_leaves(params).items():
        leaf.copy_(w[name])


def read_tree(tree, scale: float = 1.0) -> dict:
    return {n: x.detach().clone() * scale
            for n, x in program_leaves(tree).items()}


@torch.no_grad()
def reset_adam(opt):
    for tree in (opt.m1, opt.m2):
        for x in program_leaves(tree).values():
            x.zero_()
    opt.beta_t_1.fill_(0.9)
    opt.beta_t_2.fill_(0.999)
    opt.step.zero_()


def window_batch(rs, ep, t, W: int, rho0) -> dict:
    """A checked step's rows for the reference: the window [t-W+1, t+1]
    of stored states of each row's slot with each position's active flag
    (t' >= 0) as a last column (frames [B, W+1, dimS + 1]), and the
    step's stored fields at t."""
    ep, t = ep.long(), t.long()
    tw = t[:, None] + torch.arange(-W + 1, 2, device=t.device)[None, :]
    active = (tw >= 0)[..., None].to(rs.states_tm.dtype)
    states = rs.states_tm[torch.clamp(tw, 0, rs.max_len), ep[:, None]]
    L1 = rs.states_tm.shape[0]
    return {"frames": torch.cat([states, active], -1),
            "action": rs.actions_tm[t, ep].clone(),
            "mu": rs.mus_tm[t, ep].clone(),
            "qret": rs.qret_tm[t, ep].clone(),
            "valid": (rs.slot_id[ep] >= 0) & (t < rs.slot_len[ep]),
            "rho_old": rho0[t, ep].clone(),
            "key": (ep * L1 + t).cpu()}


def _np(x):
    return x.detach().cpu().numpy()


class Setup(train_fused.Setup):
    """The trainer through its set-up, with the readings the checks need
    (train_fused.Setup's, in its order; see the module docstring)."""

    def __init__(self, files, ref, seed, options):
        conf = {**files["config"], **options.get("sizes", {})}
        self.settings = program.settings(files, options.get("sizes"))
        self.arch = ref.arch({**conf, "settings": self.settings})
        self.conf = conf
        dev = torch.device(options.get("device", "cuda"))
        self.excluded = 0.0
        # the trainer first: a program that cannot capture the step stops
        # here, before K1's build
        tr = self.tr = build_trainer(files, seed, dev, options.get("sizes"),
                                     options.get("graphs", True))
        if dev.type == "cuda":
            from smarties_tpu_torch.ops import retrace_kernel as rk
            rk.library()
        self.dev = tr.device
        self.n_train = max(1, int(round(tr.n_envs / tr.cfg.obsPerStep)))
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        pinit = ref.param_init({**conf, "settings": self.settings})
        self.w_act = ref.draw_weights(gen, self.arch, pinit, self.dev)
        self.w1 = ref.draw_weights(gen, self.arch, pinit, self.dev)
        self.ref = ref
        write_weights(tr.params, self.w_act)
        rs = tr.replay
        # the statistics the warmup acts under (a fresh replay's)
        acting = (rs.state_mean.clone(), rs.state_scale.clone())
        tr.warmup(chunk=1, blind_sweeps=-(-conf["fill_env_steps"]
                                          // tr.n_envs))
        self.snap = {"seed": seed}
        t0 = time.perf_counter()
        self.snap["stats"] = self._stats(rs)
        self.excluded += time.perf_counter() - t0
        rng = np.random.default_rng(seed)
        valid = torch.nonzero(rs.slot_id >= 0)[:, 0].cpu().numpy()
        pick = torch.as_tensor(np.sort(rng.choice(
            valid, min(N_INIT_SLOTS, valid.size), replace=False)),
            device=self.dev)
        self.snap["init_cols"] = train_fused._columns(rs, pick)
        acted = pick[:N_ENV_SLOTS]
        self.snap["acted"] = {
            "w": {k: v.clone() for k, v in self.w_act.items()},
            "mean": acting[0], "scale": acting[1],
            "cols": {"states": _np(rs.states_tm[:, acted].transpose(0, 1)),
                     "mus": _np(rs.mus_tm[:, acted].transpose(0, 1)
                                ).astype(np.float64),
                     "length": _np(rs.slot_len[acted])}}
        # the step graph's two eager warm-up calls; the sweep graph was
        # captured in the warmup's one-sweep chunks (its third)
        for _ in range(2):
            tr._train_chunk(1)
            tr.n_grad_steps += 1
        sid = rs.slot_id.clone()
        es, ip = tr.carry.env_state, tr.carry.inprog
        u0, t_0 = es.u.clone(), ip.t.long().clone()
        tr._sweep(1)
        tr.n_env_steps += tr.n_envs
        self.snap["lanes"] = self._lanes(u0, t_0)
        new = torch.nonzero((rs.slot_id != sid) & (rs.slot_id >= 0))[:, 0]
        self.snap["ingest_cols"] = train_fused._columns(rs, new)
        self._steps()
        tr.train_fused(tr.n_envs, log_every=10 ** 12, flush=False)
        train_fused._sync(self.dev)

    def _lanes(self, u0, t_0) -> dict:
        """The checked sweep's step of every lane that did not end in it:
        its full state before and after, its stored action and the
        observation stored for the state before (float64 numpy)."""
        es, ip = self.tr.carry.env_state, self.tr.carry.inprog
        kept = torch.nonzero(ip.t.long() == t_0 + 1)[:, 0]
        t = t_0[kept]
        return {"u0": _np(u0[kept]).astype(np.float64),
                "u1": _np(es.u[kept]).astype(np.float64),
                "action": _np(ip.actions[t, kept]).astype(np.float64),
                "served": _np(ip.states[t, kept]).astype(np.float64)}

    def _steps(self):
        """The three checked grad steps and what the reference needs:
        train_fused.Setup._steps's, on the presampled rows of the step
        graph, with each row's window."""
        tr = self.tr
        rs = tr.replay
        write_weights(tr.params, self.w1)
        reset_adam(tr.opt_state)
        rho0 = rs.rho_tm.clone()
        sc0 = {"beta": rs.beta.clone(), "alpha": rs.alpha.clone(),
               "cmax": rs.cmax_ret.clone(),
               "n_stored": float(rs.n_stored_steps()),
               "n_far": float(rs.far_count.sum())}
        mean, scale = rs.state_mean.clone(), rs.state_scale.clone()
        m1 = tr._train_chunk(1)
        pins = tr._step_rows[3]
        idx = [(pins[0][0].clone(), pins[1][0].clone())]
        g1 = read_tree(tr.opt_state.m1, 1 / 0.1)
        rho1 = train_fused._written_rho(rs, *idx[0])
        m23 = tr._train_chunk(N_STEPS - 1)
        idx += [(pins[0][k].clone(), pins[1][k].clone())
                for k in range(N_STEPS - 1)]
        losses = [float(m1["rmse"][0])] + [float(x) for x in m23["rmse"]]
        tr.n_grad_steps += N_STEPS
        p3 = read_tree(tr.params)
        W = tr.cfg.nnBPTTseq
        self.snap["steps"] = {
            "batches": [window_batch(rs, ep, t, W, rho0) for ep, t in idx],
            "sc0": sc0, "mean": mean, "scale": scale,
            "w1": {k: v.clone() for k, v in self.w1.items()},
            "prog": {"losses": losses, "grad": g1, "w3": p3, "rho": rho1}}


# ----------------------------------------------------------------------
# the checks
# ----------------------------------------------------------------------

def _env_and_mu(out: dict, snap, ref, arch) -> dict:
    """train_fused's numbers with the lanes' state gap and mu."""
    out["env_state"] = max(out["env_state"], ref.lane_gaps(snap["lanes"]))
    a = snap["acted"]
    w = {k: v.double() for k, v in a["w"].items()}
    out["mu"] = ref.behaviour_gap(w, arch, a["cols"], a["mean"].double(),
                                  a["scale"].double())
    return out


def check(snap, ref, arch, settings) -> dict:
    """Every number compared for `correct`: the program against the
    reference (float64)."""
    return _env_and_mu(train_fused.check(snap, ref, arch, settings), snap,
                       ref, arch)


def control(snap, ref, arch, settings) -> dict:
    """train_fused.control's readings, the program's with env_state and
    mu as `check` has them."""
    out = train_fused.control(snap, ref, arch, settings)
    _env_and_mu(out["program"], snap, ref, arch)
    return out


# ----------------------------------------------------------------------
# the run
# ----------------------------------------------------------------------

def run(files, ref, seed, seconds, trace, options, t_start) -> dict:
    mix = files["mix"]
    s = Setup(files, ref, seed, options)
    tr, dev = s.tr, s.dev
    # untimed cycles: a process's captured steps run slower for its first
    # seconds on the card (PERF.md, section 7)
    warm_s = options.get("warm_s", mix.get("warm_s", 0))
    train_phases._cycles(tr, warm_s)
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
    a = s.arch
    ctx = {"spans": spans, "grad_steps": grad_steps, "window_s": window_s,
           "flops_per_step": bptt_flops.step_flops(
               tr.cfg.nnType, a["n_in"], a["hidden"], a["n_out"],
               tr.cfg.batchSize, tr.cfg.nnBPTTseq),
           "peaks": yardstick.peaks(name)}
    out = {"end_to_end": {"grad_steps_per_s": grad_steps / window_s,
                          "setup_s": setup_s},
           "attempted": grad_steps, "failed": 0, "device": device}
    if trace and cuda:
        reading = btrace.profile(lambda: tr._fused_cycle(1, TRACED_STEPS))
        ctx["trace"] = reading
        device["busy_s"] = btrace.busy_us(reading) / 1e6
        device["window_s"] = btrace.window_us(reading) / 1e6
        out["breakdown"] = btrace.breakdown(reading)
    if trace:
        tr.profiler.trace()
        train_phases._cycles(tr, warm_s)
        tr.profiler.reset()
        train_phases._cycles(tr, n=mix.get("phase_cycles", 4))
        ctx["phases"] = tr.profiler.summary()
        print(f"phases: {ctx['phases']}", file=sys.stderr)
    snap, arch = s.snap, s.arch
    del s, tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["numbers"] = check(snap, ref, arch,
                           program.settings(files, options.get("sizes")))
    out["ctx"] = ctx
    return out

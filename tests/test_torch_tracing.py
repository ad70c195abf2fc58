"""The phase profiler's tracing (utils/profiler.py) and the traced grad
step (runtime/trainer.py, ops/stamp.py), at a small size.

On the CPU:
- span records nest: parent, cycle index, host times in order; the
  phases' totals and counts read the same with tracing on and off, and
  no traced span enters them;
- the Chrome export parses, its spans nest, and written onto a
  torch.profiler trace it shares that trace's time base (an annotation
  of torch's lies inside the span that enclosed it);
- the device-to-host mapping through calibration pairs, and the idle
  gaps labelled by the host span open when the card resumed;
- Trainer(graphs=True) traced equals untraced bit for bit after two
  fused cycles and a refresh; the stamp buffer holds rows x stamps
  ordered times; the traced step's ops are the plain step's and the
  stamps', in the same order;
- a learner without step phases records its whole replays only.

Marked `cuda`: on the card the traced step graph equals the plain one
bit for bit, and in one torch.profiler trace of a traced cycle each K1
kernel lies inside the exported ROLL interval. This file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_tracing.py
"""
import json
import time

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from smarties_tpu_torch import launch
from smarties_tpu_torch.runtime import graphs as cg
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils import profiler as prof_mod
from smarties_tpu_torch.utils.config import HyperParameters
from smarties_tpu_torch.utils.profiler import Profiler

torch.set_num_threads(1)

N_ENVS, N_SLOTS, MAX_LEN = 16, 64, 64
CFG = dict(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
           nnLayerSizes=[16, 16], obsPerStep=1.0, randSeed=0)
PHASES = ("gather", "forward", "backward", "adam", "writeback")


def _trainer(device="cpu", graphs=True, app="cartpole", **kw):
    env = launch.env_module(app)
    return Trainer(env, env.MDP, HyperParameters(**dict(CFG, **kw)),
                   n_envs=N_ENVS, n_slots=N_SLOTS, max_len=MAX_LEN,
                   device=device, graphs=graphs)


def _state(tr):
    out = []

    def walk(x, name):
        if isinstance(x, torch.Tensor):
            out.append((name, x))
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{name}.{k}")
        elif isinstance(x, (list, tuple)):
            for k, v in zip(getattr(x, "_fields", range(len(x))), x):
                walk(v, f"{name}.{k}")
        elif hasattr(x, "__dataclass_fields__"):
            for f in x.__dataclass_fields__:
                walk(getattr(x, f), f"{name}.{f}")

    walk({"params": tr.params, "opt": tr.opt_state, "carry": tr.carry}, "")
    return out


def _assert_same(a, b):
    sa, sb = _state(a), _state(b)
    assert [k for k, _ in sa] == [k for k, _ in sb]
    for (k, x), (_, y) in zip(sa, sb):
        assert torch.equal(x.detach().cpu(), y.detach().cpu()), k
    for g in ("env", "act", "batch", "eval"):
        assert torch.equal(getattr(a, "gen_" + g).get_state(),
                           getattr(b, "gen_" + g).get_state()), g


def test_records_nest():
    p = Profiler("cpu")
    with p("ROLL"):                   # before tracing: no record
        pass
    p.trace()
    p.cycle = 1
    with p("TRAIN"):
        with p.span("PRESAMPLE"):
            sum(range(1000))
        for _ in range(3):
            s = p.begin("STEP")
            sum(range(1000))
            p.end(s)
    p.cycle = 2
    with p("ROLL"):
        with p.span("LOGS"):
            pass
    p.trace(False)
    with p.span("METRICS"):           # tracing off: nothing
        pass
    with p("HOST"):
        pass
    recs = p.read()
    assert [r.name for r in recs] == ["TRAIN", "PRESAMPLE", "STEP", "STEP",
                                      "STEP", "ROLL", "LOGS"]
    assert [r.parent for r in recs] == [-1, 0, 0, 0, 0, -1, 5]
    assert [r.cycle for r in recs] == [1, 1, 1, 1, 1, 2, 2]
    for r in recs:
        assert r.host0 <= r.host1
        assert (r.dev0, r.dev1) == (r.host0, r.host1)   # the CPU's
        if r.parent >= 0:
            par = recs[r.parent]
            assert par.host0 <= r.host0 <= r.host1 <= par.host1
    assert all(a.host0 <= b.host0 for a, b in zip(recs, recs[1:]))
    assert dict(p.counts) == {"ROLL": 2, "TRAIN": 1, "HOST": 1}
    assert set(p.totals) == {"ROLL", "TRAIN", "HOST"}
    p.reset()
    assert p.read() == [] and not p.counts


def test_mapping_and_its_error():
    xs, hs = [0.0, 1e9, 2e9], [5e9, 6e9 + 10, 7e9 + 20]
    assert prof_mod._map(0.5e9, xs, hs) == pytest.approx(5.5e9 + 5)
    assert prof_mod._map(3e9, xs, hs) == pytest.approx(8e9 + 30)
    assert prof_mod._map(-1e9, [0.0], [5e9]) == 4e9
    # the middle pair lies 7 ns off its neighbours' line; widest half 3
    err = prof_mod._fit_error([0.0, 1e9, 2e9], [0.0, 1e9 + 7, 2e9],
                              [1.0, 3.0, 2.0])
    assert err == pytest.approx(10.0)
    assert prof_mod._fit_error([0.0], [0.0], [4.0]) == 4.0


def test_gaps_are_labelled_by_the_open_host_span():
    p = Profiler("cpu")
    p.trace()

    def span(name, parent, h0, h1, d0, d1):
        s = prof_mod.Span(name, parent, 1, h0)
        s.host1, s._raw = h1, (d0, d1)
        p.records.append(s)

    # host: TRAIN [0, 100] holds STEP [10, 20] and STEP [30, 40], then
    # HOST [100, 130]; the card runs the steps late
    span("TRAIN", -1, 0, 100, 50, 300)
    span("STEP", 0, 10, 20, 50, 150)
    span("STEP", 0, 30, 40, 160, 250)
    span("HOST", -1, 100, 130, 280, 300)
    # the card resumed at 160 and at 280, when the host was in no span
    assert p.gaps() == [(150, 160, "none"), (250, 280, "none")]
    # then REFRESH [140, 400] opens (with a STEP inside, [150, 155]): the
    # host is in it when the card resumes at 160, 280 and 320
    span("REFRESH", -1, 140, 400, 290, 310)
    span("STEP", 4, 150, 155, 320, 330)
    assert p.gaps() == [(150, 160, "REFRESH"), (250, 280, "REFRESH"),
                        (310, 320, "REFRESH")]
    s = p.summary()
    assert s["window_ms"] == pytest.approx((330 - 50) / 1e6)
    assert s["device_gap_share"] == pytest.approx(100 * 50 / 280)


def test_chrome_export_nests_and_overlays_torch_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile, record_function
    p = Profiler("cpu")
    p.trace()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with p("ROLL"):
            with p.span("LOGS"):
                with record_function("inside_logs"):
                    time.sleep(0.002)
    torch_trace = str(tmp_path / "torch.json")
    prof.export_chrome_trace(torch_trace)
    out = str(tmp_path / "both.json")
    p.export_chrome_trace(out, onto=torch_trace)
    mine = str(tmp_path / "mine.json")
    p.export_chrome_trace(mine)
    with open(torch_trace) as f:
        theirs = json.load(f)
    with open(out) as f:
        both = json.load(f)
    assert both.get("baseTimeNanoseconds") == theirs.get(
        "baseTimeNanoseconds")
    ev = both["traceEvents"]
    assert len(ev) > len(theirs["traceEvents"])
    ours = {(e["name"], e["tid"]): e for e in ev
            if e.get("cat") == "smarties_profiler"}
    ann, = [e for e in ev if e.get("name") == "inside_logs"]
    for tid in (1_000_001, 1_000_002):
        roll, logs = ours["ROLL", tid], ours["LOGS", tid]
        assert roll["ts"] <= logs["ts"]
        assert logs["ts"] + logs["dur"] <= roll["ts"] + roll["dur"]
        assert logs["args"]["parent"] == "ROLL"
        # one clock: torch's annotation inside the span around it, to
        # within the printed precision of both
        assert logs["ts"] - 1 <= ann["ts"]
        assert ann["ts"] + ann["dur"] <= logs["ts"] + logs["dur"] + 1
    with open(mine) as f:
        alone = json.load(f)
    assert "baseTimeNanoseconds" in alone
    names = {e["name"] for e in alone["traceEvents"] if e["ph"] == "X"}
    assert names == {"ROLL", "LOGS"}


def _run(tr, trace_from_start: bool):
    if trace_from_start:
        tr.profiler.trace()
    tr.warmup(chunk=16)
    tr.train_fused(2 * N_ENVS, log_every=10 ** 9)      # two fused cycles
    tr._update_replay(tr._refresh, 1000.0)
    tr.train_fused(N_ENVS, log_every=10 ** 9)


def test_traced_cycle_equals_untraced():
    plain, traced = _trainer(), _trainer()
    _run(plain, False)
    _run(traced, True)
    _assert_same(plain, traced)
    assert list(plain._step_graphs) == [True]
    assert list(traced._step_graphs) == [(True, "traced")]
    for k in plain.profiler.counts:
        assert plain.profiler.counts[k] == traced.profiler.counts[k], k
    assert set(plain.profiler.totals) == set(traced.profiler.totals)
    # the stamp rows: rows x (phases + 1), each row's times in order
    rows = traced._step_rows[0]
    st = traced._stamp_rows
    assert st.shape == (rows, len(PHASES) + 1)
    assert torch.all(st[:N_ENVS, 1:] >= st[:N_ENVS, :-1])
    assert torch.all(st[1:N_ENVS, 0] >= st[:N_ENVS - 1, -1])
    recs = traced.profiler.read()
    steps = [r for r in recs if r.name == "STEP"]
    assert len(steps) == 3 * N_ENVS
    for r in steps:
        assert [n for n, _, _ in r.phases] == list(PHASES)
        assert r.host0 <= r.phases[0][1] <= r.phases[-1][2] <= r.host1
        assert recs[r.parent].name == "TRAIN"
    by_cycle = {}
    for r in recs:
        by_cycle.setdefault(r.cycle, []).append(r.name)
    for c, names in by_cycle.items():
        if c == 0:                    # the warmup's sweeps
            assert set(names) == {"ROLL", "LOGS"}
            continue
        assert names.count("STEP") == N_ENVS
        assert names.count("PRESAMPLE") == 2
        assert names.count("METRICS") == 1 and names.count("LOGS") == 1
    s = traced.profiler.summary(cycles=[1, 2])
    assert s["cycles"] == 2 and s["steps"] == 2 * N_ENVS
    assert set(s["phases_ms"]) == set(PHASES)
    assert 0.0 <= s["device_gap_share"] < 100.0


def test_tracing_off_again_replays_the_plain_graph():
    tr = _trainer()
    tr.warmup(chunk=16)
    tr.train_fused(N_ENVS, log_every=10 ** 9)
    tr.profiler.trace()
    tr.train_fused(N_ENVS, log_every=10 ** 9)
    tr.profiler.trace(False)
    n = len(tr.profiler.records)
    tr.train_fused(N_ENVS, log_every=10 ** 9)
    assert len(tr.profiler.records) == n
    assert sorted(tr._step_graphs, key=str) == [(True, "traced"), True]
    assert tr._step_graphs[True].calls == 2 * N_ENVS


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.name())
        return func(*args, **(kwargs or {}))


def test_traced_step_is_the_plain_step_and_the_stamps():
    """The ops of one traced step are those of the plain step with a
    stamp's (select, index_fill_ on the CPU) at each phase boundary: the
    plain step has none, and tracing adds nothing else to the step."""
    tr = _trainer()
    tr.warmup(chunk=16, blind_sweeps=16)
    tr._train_chunk(2)
    tr.profiler.trace()
    tr._train_chunk(2)
    seen = []
    for key in (True, (True, "traced")):
        tr._step_rows[1].zero_()
        mode = _Ops()
        with mode:
            tr._step_graphs[key]()
        seen.append(mode.names)
    plain, traced = seen
    fill = "aten::index_fill_.int_Scalar"
    assert fill not in plain
    assert traced.count(fill) == len(PHASES) + 1
    rest = list(traced)
    for k in range(len(rest) - 1, -1, -1):
        if rest[k] == fill:
            assert rest[k - 1] == "aten::select.int"
            del rest[k - 1:k + 1]
    assert rest == plain


def test_learner_without_phases_records_whole_replays():
    tr = _trainer(app="cartpole_discrete", learner="DQN", clipImpWeight=0.0)
    tr.profiler.trace()
    tr.warmup(chunk=16)
    tr.train_fused(N_ENVS, log_every=10 ** 9)
    assert list(tr._step_graphs) == [True]
    steps = [r for r in tr.profiler.read() if r.name == "STEP"]
    assert len(steps) == N_ENVS and all(r.phases is None for r in steps)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_traced_graph_on_card(cuda, tmp_path):
    """The traced step graph equals the plain one bit for bit over 8
    replays (after its eager calls and its capture), and the exported
    trace shares torch.profiler's clock: each K1 kernel of a traced
    cycle lies inside the exported ROLL interval within 50 µs."""
    from torch.profiler import ProfilerActivity, profile

    from smarties_tpu_torch.ops.stamp import timer_ticks_ns
    plain, traced = _trainer(cuda, None), _trainer(cuda, None)
    assert plain.graphs and traced.graphs
    for tr in (plain, traced):
        tr.warmup(chunk=16)
        tr._train_chunk(4)
        torch.cuda.synchronize()
    traced.profiler.trace()
    for tr in (plain, traced):
        for _ in range(cg.WARMUP_CALLS + 1):
            tr._train_chunk(1)
        tr._train_chunk(8)
        torch.cuda.synchronize()
    assert traced._step_graphs[True, "traced"].graph is not None
    _assert_same(plain, traced)
    st = traced._stamp_rows[:8].cpu()
    assert torch.all(st[:, 1:] > st[:, :-1])
    ticks = timer_ticks_ns(cuda)
    assert 0 < min(ticks) <= 2000, ticks

    tr = traced
    for _ in range(cg.WARMUP_CALLS + 1):    # the sweep graph captured
        tr.train_fused(N_ENVS, log_every=10 ** 9)
    tr.profiler.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_fused(N_ENVS, log_every=10 ** 9)
        torch.cuda.synchronize()
    theirs = str(tmp_path / "torch.json")
    prof.export_chrome_trace(theirs)
    both = str(tmp_path / "both.json")
    tr.profiler.export_chrome_trace(both, onto=theirs)
    assert tr.profiler.mapping_error_ns() < 50_000
    with open(both) as f:
        ev = json.load(f)["traceEvents"]
    roll, = [e for e in ev if e.get("cat") == "smarties_profiler"
             and e["name"] == "ROLL" and e["tid"] == 1_000_002]
    k1 = [e for e in ev if e.get("ph") == "X" and "retrace" in e["name"]
          and e.get("cat") == "kernel"]
    assert k1
    for e in k1:
        assert roll["ts"] - 50 <= e["ts"]
        assert e["ts"] + e["dur"] <= roll["ts"] + roll["dur"] + 50


@pytest.mark.cuda
def test_conv_traced_graph_on_card(cuda):
    """The traced conv step graph (its backward stamp launched from
    autograd's thread into the capture) equals the plain one bit for bit
    over 8 replays, and its stamps are in order."""
    from smarties_tpu_torch.envs import catch
    env = catch.small
    cfg = dict(CFG, learner="RACER", nnLayerSizes=[16], batchSize=8,
               minTotObsNum=64, maxTotObsNum=256)
    plain, traced = (Trainer(env, env.MDP, HyperParameters(**cfg),
                             n_envs=4, n_slots=32, max_len=env.MAX_STEPS,
                             device=cuda, state_dtype=torch.uint8)
                     for _ in range(2))
    assert plain.graphs and traced.graphs
    for tr in (plain, traced):
        tr.warmup(chunk=1, blind_sweeps=28)
        tr._train_chunk(4)
        torch.cuda.synchronize()
    traced.profiler.trace()
    for tr in (plain, traced):
        for _ in range(cg.WARMUP_CALLS + 1):
            tr._train_chunk(1)
        tr._train_chunk(8)
        torch.cuda.synchronize()
    assert traced._step_graphs[True, "traced"].graph is not None
    _assert_same(plain, traced)
    st = traced._stamp_rows[:8].cpu()
    assert st.shape[1] == len(CONV_PHASES) + 1
    assert torch.all(st[:, 1:] >= st[:, :-1])
    s = traced.profiler.summary()
    assert set(s["phases_ms"]) == set(CONV_PHASES) and s["conv_tflop_s"] > 0


def test_profile_main_trace_runs_on_the_cpu(tmp_path, capsys):
    """`profile_main --trace`'s loop at a small size: one row per traced
    cycle after the plain ones, the cost turns, the Chrome trace."""
    from smarties_tpu_torch.runtime import profile_main as pm
    out = str(tmp_path / "main.trace.json")
    rows = pm.trace_main(0.0, plain_s=0.01, out=out, device="cpu",
                         n_envs=N_ENVS, n_slots=N_SLOTS, fill_sweeps=16)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert "plain_train_ms_per_step" in lines[0]
    assert len(rows) == 1 and set(rows[0]["phases_ms"]) == set(PHASES)
    assert [x["traced"] for x in lines if "traced" in x] == [
        False, True, True, False]
    assert lines[-1]["trace"] == out
    with open(out) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert {"TRAIN", "STEP", "PRESAMPLE", "METRICS", "ROLL", "LOGS",
            *PHASES} <= names


# ---------------------------------------------------------------------
# a learner with a conv stack: RACER-discrete on the 20x20 catch board

CONV_PHASES = ("gather", "conv_forward", "forward", "backward",
               "conv_backward", "adam", "writeback")


def _conv_trainer(graphs=True):
    from smarties_tpu_torch.envs import catch
    env = catch.small
    cfg = dict(CFG, learner="RACER", nnLayerSizes=[16], batchSize=8,
               minTotObsNum=64, maxTotObsNum=256)
    return Trainer(env, env.MDP, HyperParameters(**cfg), n_envs=4,
                   n_slots=32, max_len=env.MAX_STEPS, device="cpu",
                   graphs=graphs, state_dtype=torch.uint8)


def test_dense_learners_keep_their_phases():
    """Only a feed-forward net with a conv stack gets the conv phases."""
    assert _trainer().algo.step_phases == PHASES
    assert _trainer(learner="RACER").algo.step_phases == PHASES
    assert _conv_trainer().algo.step_phases == CONV_PHASES


def test_conv_phases_in_order_sum_to_the_replay_and_count_macs():
    """The traced conv step's phases follow one another, the old forward
    (gather's end to forward's end) holds conv_forward, their sum is the
    stamped replay inside its STEP span, and the counter is the stack's
    multiply-adds over [s_t; s_t1] as benchmark/yardstick.py counts them
    from the shapes."""
    from benchmark import yardstick
    tr = _conv_trainer()
    tr.profiler.trace()
    tr.warmup(chunk=1, blind_sweeps=28)
    tr.train_fused(8, log_every=10 ** 9)
    steps = [r for r in tr.profiler.read() if r.name == "STEP"]
    assert len(steps) == 8
    for r in steps:
        assert [n for n, _, _ in r.phases] == list(CONV_PHASES)
        for (_, _, end), (_, start, _) in zip(r.phases, r.phases[1:]):
            assert start == end
        assert all(a <= b for _, a, b in r.phases)
        ph = {n: (a, b) for n, a, b in r.phases}
        assert ph["gather"][1] <= ph["conv_forward"][0] \
            <= ph["conv_forward"][1] <= ph["forward"][1]
        total = sum(b - a for _, a, b in r.phases)
        assert total == r.phases[-1][2] - r.phases[0][1]
        assert r.host0 <= r.phases[0][1] and r.phases[-1][2] <= r.host1
        assert total > 0.5 * (r.host1 - r.host0)
    conv = tr.algo.mdp.conv_layers
    sizes = [16, 16, tr.algo.spec.n_out]      # the dense part is not read
    rows = 2 * tr.cfg.batchSize
    want = [rows * m for m in yardstick.dense_macs(conv, sizes)[:len(conv)]]
    assert list(tr.profiler.counters["conv_macs"]) == want
    s = tr.profiler.summary()
    assert set(s["phases_ms"]) == set(CONV_PHASES)
    assert s["conv_macs"] == sum(want)
    conv_s = (s["phases_ms"]["conv_forward"]
              + s["phases_ms"]["conv_backward"]) / 1e3
    assert s["conv_tflop_s"] == pytest.approx(
        2 * (3 * sum(want) - want[0]) / conv_s / 1e12)
    # a dense learner's summary has no conv entries
    d = _trainer()
    d.profiler.trace()
    d.warmup(chunk=16, blind_sweeps=16)
    d._train_chunk(2)
    assert "conv_macs" not in d.profiler.summary() and \
        not d.profiler.counters


def test_conv_traced_step_is_the_plain_step_the_stamps_and_a_view():
    """The traced conv step's ops are the plain step's with a stamp's at
    each phase boundary and the identity that marks where the backward
    pass reaches the stack's output (one view): the plain step graph,
    which the window times, has none of them."""
    tr = _conv_trainer()
    tr.warmup(chunk=1, blind_sweeps=14)
    tr._train_chunk(2)
    tr.profiler.trace()
    tr._train_chunk(2)
    seen = []
    for key in (True, (True, "traced")):
        tr._step_rows[1].zero_()
        mode = _Ops()
        with mode:
            tr._step_graphs[key]()
        seen.append(mode.names)
    plain, traced = seen
    fill = "aten::index_fill_.int_Scalar"
    assert fill not in plain
    assert traced.count(fill) == len(CONV_PHASES) + 1
    rest = list(traced)
    for k in range(len(rest) - 1, -1, -1):
        if rest[k] == fill:
            assert rest[k - 1] == "aten::select.int"
            del rest[k - 1:k + 1]
    k = next(k for k, (a, b) in enumerate(zip(rest, plain)) if a != b)
    assert rest[k] == "aten::view"
    assert rest[:k] + rest[k + 1:] == plain


# ---------------------------------------------------------------------
# a recurrent net: V-RACER with an LSTM on the no-velocity cart-pole

RNN_PHASES = ("gather", "bptt_forward", "head", "bptt_backward", "adam",
              "writeback")


@pytest.mark.parametrize("kind, gates", [("LSTM", 4), ("GRU", 2)])
def test_recurrent_phases_in_order_and_count_cells(kind, gates):
    """The traced recurrent step stamps its six phases, in order, summing
    to the stamped replay; bptt_cells is (2W + 1) x layers and bptt_macs
    each layer's gates x (in h + h h) over the window's W + 1 positions
    and the batch's rows; the summary gives one cell's µs."""
    W = 4
    tr = _trainer(app="cartpole_pomdp", nnType=kind, nnBPTTseq=W,
                  nnLayerSizes=[8, 6])
    assert tr.algo.step_phases == RNN_PHASES
    tr.profiler.trace()
    tr.warmup(chunk=16, blind_sweeps=16)
    tr.train_fused(N_ENVS, log_every=10 ** 9)
    steps = [r for r in tr.profiler.read() if r.name == "STEP"]
    assert len(steps) == N_ENVS
    for r in steps:
        assert [n for n, _, _ in r.phases] == list(RNN_PHASES)
        for (_, _, end), (_, start, _) in zip(r.phases, r.phases[1:]):
            assert start == end
        assert all(a <= b for _, a, b in r.phases)
        assert r.host0 <= r.phases[0][1] and r.phases[-1][2] <= r.host1
    B, n_in = CFG["batchSize"], tr.mdp.dim_net_input
    assert tr.profiler.counters["bptt_cells"] == (2 * W + 1) * 2
    assert list(tr.profiler.counters["bptt_macs"]) == [
        B * (W + 1) * gates * (a * h + h * h)
        for a, h in ((n_in, 8), (8, 6))]
    s = tr.profiler.summary()
    assert set(s["phases_ms"]) == set(RNN_PHASES)
    assert s["bptt_cells"] == 18
    assert s["bptt_cell_us"] == pytest.approx(
        (s["phases_ms"]["bptt_forward"] + s["phases_ms"]["bptt_backward"])
        * 1e3 / 18)
    assert "conv_macs" not in s


def test_recurrent_traced_cycle_equals_untraced():
    """The recurrent step traced, from the start, equals it untraced bit
    for bit over two fused cycles and a refresh."""
    trs = []
    for traced in (False, True):
        tr = _trainer(app="cartpole_pomdp", nnType="LSTM", nnBPTTseq=4)
        if traced:
            tr.profiler.trace()
        tr.warmup(chunk=16)
        for _ in range(2):
            tr.train_fused(N_ENVS, log_every=10 ** 9)
        tr._update_replay(tr._refresh, 1000.0)
        trs.append(tr)
    _assert_same(*trs)
    assert (True, "traced") in trs[1]._step_graphs


def test_profile_main_traces_the_recurrent_step_on_the_cpu(tmp_path, capsys):
    """`profile_main --trace --trace-rnn`'s loop at a small size: the
    RACER_RNN recipe on cartpole.pomdp, one row with the window's phases
    and its cell counts."""
    from smarties_tpu_torch.runtime import profile_main as pm
    rows = pm.trace_main(0.0, device="cpu", n_envs=N_ENVS, n_slots=N_SLOTS,
                         fill_sweeps=4, rnn=True)
    capsys.readouterr()
    assert len(rows) == 1 and set(rows[0]["phases_ms"]) == set(RNN_PHASES)
    assert rows[0]["bptt_cells"] == (2 * 16 + 1) * 2
    assert rows[0]["bptt_cell_us"] > 0

"""The Trainer's captured programs (runtime/graphs.py) at a small size.

The Trainer captures the env sweep (with its commit and the at-ingest K1
sweep) and the grad step of every off-policy learner with a feed-forward
net as CUDA graphs on a card: V-RACER's main path, RACER (Gaussian and
discrete), DQN, NAF, DPG and MixedPG, on uniform minibatches drawn up
front or with the prioritized draw (PERrank, PERerr, PERseq) inside the
step; and the V-RACER family with a recurrent net (V-RACER with an
LSTM, a GRU or an RNN on the no-velocity cart-pole, RACER with an LSTM,
RACER-discrete with a GRU): its truncated-BPTT step and the acting carry
of every lane, which the sweep threads and zeroes where an episode ends. A graph replays the addresses it captured, so what it needs of the
code is held here on the CPU, at tests/test_fused.py's sizes (16 envs,
64 slots):

(a) one train step, one sweep with its ingest, the 1000-step refresh and
    a save / restore round trip leave every tensor of the params (target
    nets included), the optimiser state, the replay, the in-progress
    episodes, the env state and the acting carry (the recurrent nets'
    (h, c) or h of every layer) in its own storage;
(b) no host-reading op in a grad step or a sweep (a TorchDispatchMode
    over them): no .item(), nonzero, masked_select, unique, and no
    indexing by a bool mask; for each learner, each prioritized draw and
    the commit under each episode filter;
(c) the static-buffer form of the cycle that the card captures, run
    uncaptured on the CPU (Trainer(graphs=True)), equals the eager loop
    (graphs=False) bit for bit, the four generator states included: two
    fused cycles, one on pinned presamples, with the refresh, and a chunk
    longer than the static buffers;
(d) marked `cuda`: on the card the captured cycle equals the eager one
    (torch.equal), K1 counts one launch per ingest replay, and a step is
    one graph launch.

Which learners the Trainer captures is a property of the learner; the
others raise when graphs are asked for.

This file imports neither jax nor the JAX package, so the `cuda` test
runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_graphs.py
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from smarties_tpu_torch import launch
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters

torch.set_num_threads(1)

N_ENVS, N_SLOTS, MAX_LEN = 16, 64, 64
CFG = dict(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
           nnLayerSizes=[16, 16], obsPerStep=1.0, randSeed=0)
GENS = ("env", "act", "batch", "eval")

# the captured paths beside V-RACER's uniform main path: name -> (app,
# settings, tensors one train step must move, tensors one sweep must move
# beyond the cursor and the env state)
PATHS = {
    "racer": ("cartpole", dict(learner="RACER"),
              ("params.layers.0.W", "opt.step", "carry.replay.rho_tm"), ()),
    "racer_discrete": ("cartpole_discrete", dict(learner="RACER"),
                       ("params.layers.0.W", "opt.step",
                        "carry.replay.rho_tm"), ()),
    # Boltzmann, 1-step targets, a periodic target copy
    "dqn": ("cartpole_discrete", dict(learner="DQN", clipImpWeight=0.0,
                                      targetDelay=2),
            ("params.net.layers.0.W", "opt.step", "carry.replay.delta_tm"),
            ()),
    "dqn_eps_greedy": ("cartpole_discrete",
                       dict(learner="DQN", dqnEpsGreedy=True, explNoise=0.1,
                            clipImpWeight=0.0, targetDelay=0.01),
                       ("params.net.layers.0.W", "params.tgt.layers.0.W",
                        "opt.step"), ()),
    "dqn_refer_retrace": ("cartpole_discrete",
                          dict(learner="DQN", clipImpWeight=4.0,
                               returnsEstimator="retrace", targetDelay=1e-3),
                          ("params.net.layers.0.W", "params.tgt.layers.0.W",
                           "carry.replay.beta"), ()),
    # OU acting (clipImpWeight 0), 1-step targets, Polyak targets
    "naf": ("pendulum", dict(learner="NAF", clipImpWeight=0.0,
                             targetDelay=0.01),
            ("params.net.layers.0.W", "params.tgt.layers.0.W", "opt.step"),
            ("carry.rnn.0",)),
    # OU acting and the split Adam
    "dpg": ("pendulum", dict(learner="DPG", clipImpWeight=0.0,
                             encoderLayerSizes=[16], targetDelay=0.01),
            ("params.net.critic.layers.0.W", "params.net.enc.out.W",
             "params.tgt.actor.out.W", "opt.step"), ("carry.rnn.0",)),
    # the adaptive factors
    "mixedpg": ("cartpole", dict(learner="MixedPG"),
                ("params.actor.layers.0.W", "opt.adam.step",
                 "opt.dpg_factor", "opt.err_q_factor"), ()),
    # the prioritized draws inside the step
    "PERrank": ("cartpole", dict(dataSamplingAlgo="PERrank",
                                 ERoldSeqFilter="farpolfrac"),
                ("params.layers.0.W", "opt.step"), ()),
    "PERerr": ("cartpole", dict(dataSamplingAlgo="PERerr"),
               ("params.layers.0.W", "opt.step"), ()),
    "PERseq": ("cartpole", dict(dataSamplingAlgo="PERseq"),
               ("params.layers.0.W", "opt.step"), ()),
    "naf_PERerr": ("pendulum", dict(learner="NAF", clipImpWeight=0.0,
                                    targetDelay=0.01,
                                    dataSamplingAlgo="PERerr"),
                   ("params.net.layers.0.W", "opt.step"), ()),
}
LEARNERS = ("racer", "racer_discrete", "dqn", "naf", "dpg", "mixedpg")
# V-RACER with a recurrent net: its window's leaves and the acting carry
PATHS.update({
    "lstm": ("cartpole_pomdp", dict(nnType="LSTM", nnBPTTseq=4),
             ("params.layers.0.Wc", "params.layers.1.Ro", "opt.step",
              "carry.replay.rho_tm"),
             ("carry.rnn.0.0", "carry.rnn.0.1", "carry.rnn.1.0",
              "carry.rnn.1.1")),
    "gru": ("cartpole_pomdp", dict(nnType="GRU", nnBPTTseq=4),
            ("params.layers.0.Wf", "params.layers.1.Rh", "opt.step",
             "carry.replay.rho_tm"), ("carry.rnn.0", "carry.rnn.1")),
    # the plain RNN, and RACER's Gaussian and discrete heads over the
    # window (the family shares VRacer.train_step's recurrent branch)
    "rnn": ("cartpole_pomdp", dict(nnType="RNN", nnBPTTseq=4),
            ("params.layers.0.R", "opt.step"), ("carry.rnn.0",)),
    "racer_lstm": ("cartpole_pomdp", dict(learner="RACER", nnType="LSTM",
                                          nnBPTTseq=4),
                   ("params.layers.0.Wi", "opt.step"), ("carry.rnn.0.0",)),
    "racer_discrete_gru": ("cartpole_discrete",
                           dict(learner="RACER", nnType="GRU", nnBPTTseq=4),
                           ("params.layers.0.Wh", "opt.step"),
                           ("carry.rnn.0",)),
})
RECURRENT = ("lstm", "gru")
RECURRENT_MORE = ("rnn", "racer_lstm", "racer_discrete_gru")


def _trainer(device="cpu", graphs=None, app="cartpole", **kw):
    env = launch.env_module(app)
    return Trainer(env, env.MDP, HyperParameters(**dict(CFG, **kw)),
                   n_envs=N_ENVS, n_slots=N_SLOTS, max_len=MAX_LEN,
                   device=device, graphs=graphs)


def _path_trainer(path, device="cpu", graphs=None):
    if path == "vracer":
        return _trainer(device, graphs)
    app, kw = PATHS[path][:2]
    return _trainer(device, graphs, app=app, **kw)


def _tensors(x, name=""):
    """(path, tensor) of every tensor in a tree of dicts, (named) tuples
    and dataclasses."""
    if isinstance(x, torch.Tensor):
        return [(name, x)]
    if isinstance(x, dict):
        return [p for k in sorted(x) for p in _tensors(x[k], f"{name}.{k}")]
    if isinstance(x, (list, tuple)):
        keys = getattr(x, "_fields", range(len(x)))
        return [p for k, v in zip(keys, x) for p in _tensors(v, f"{name}.{k}")]
    if dataclasses.is_dataclass(x):
        return [p for f in dataclasses.fields(x)
                for p in _tensors(getattr(x, f.name), f"{name}.{f.name}")]
    return []


def _state(tr):
    """Every tensor a captured program reads and writes, by path."""
    return [(k[1:], x) for k, x in _tensors(
        {"params": tr.params, "opt": tr.opt_state, "carry": tr.carry})]


def _assert_same_state(a, b):
    sa, sb = _state(a), _state(b)
    assert [k for k, _ in sa] == [k for k, _ in sb]
    for (k, x), (_, y) in zip(sa, sb):
        assert torch.equal(x.detach().cpu(), y.detach().cpu()), k
    for g in GENS:
        assert torch.equal(getattr(a, "gen_" + g).get_state(),
                           getattr(b, "gen_" + g).get_state()), g


MAIN_MOVES = {
    "train_step": ("params.layers.0.W", "opt.m1.layers.0.W", "opt.step",
                   "opt.beta_t_1", "carry.replay.beta",
                   "carry.replay.max_abs_error", "carry.replay.rho_tm"),
    "sweep": (),
    "refresh": ("carry.replay.rew_mean", "carry.replay.state_mean",
                "carry.replay.state_scale"),
    "restore": (),
}
SWEEP_MOVES = ("carry.inprog.t", "carry.inprog.cum_reward",
               "carry.inprog.states", "carry.env_state.step")


@pytest.mark.parametrize("path, what", [
    *(pytest.param("vracer", w, id=w) for w in MAIN_MOVES),
    *((p, w) for p in (*LEARNERS, "PERrank", *RECURRENT)
      for w in ("train_step", "sweep", "restore")),
    *((p, "refresh") for p in RECURRENT),
])
def test_state_keeps_its_storage(path, what, tmp_path):
    tr = _path_trainer(path, graphs=False)
    tr.warmup(chunk=16)
    if what == "refresh":
        tr._sweep(8)              # data the statistics have not seen
    before = [(k, x.data_ptr(), x.detach().clone()) for k, x in _state(tr)]
    if what == "train_step":
        tr.params, tr.opt_state, rs, _ = tr.algo.train_step(
            tr.params, tr.opt_state, tr.replay, gen=tr.gen_batch)
        tr.carry = tr.carry._replace(replay=rs)
        changed = (MAIN_MOVES[what] if path == "vracer"
                   else PATHS[path][2])
    elif what == "sweep":
        tr._sweep(1)
        changed = SWEEP_MOVES + (("carry.env_state.u",) if path == "vracer"
                                 else PATHS[path][3])
    elif what == "refresh":
        tr.carry = tr.carry._replace(replay=tr._refresh(tr.replay, 1000.0))
        changed = MAIN_MOVES[what]
    else:
        ckpt = str(tmp_path / "ckpt.pt")
        tr.save(ckpt)
        tr.restore(ckpt)
        changed = ()
    after = {k: x for k, x in _state(tr)}
    assert list(after) == [k for k, _, _ in before]
    assert set(changed) <= set(after), set(changed) - set(after)
    for k, ptr, old in before:
        assert after[k].data_ptr() == ptr, f"{what} rebound {k}"
        if k in changed:
            assert not torch.equal(after[k].detach(), old), \
                f"{what} left {k} as it was"
        elif what == "restore":
            assert torch.equal(after[k].detach(), old), k


# ops that read a device value back to the host (a synchronisation, and
# no capture), and the indexing ops, which do so for a bool index
HOST_READS = ("aten::_local_scalar_dense", "aten::is_nonzero", "aten::equal",
              "aten::nonzero", "aten::masked_select", "aten::unique",
              "aten::_unique", "aten::unique_consecutive")
INDEXING = ("aten::index.Tensor", "aten::index_put", "aten::index_put_",
            "aten::_index_put_impl_")


class _HostReads(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith(HOST_READS):
            self.seen.append(name)
        if name.startswith(INDEXING) and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            self.seen.append(f"{name} with a bool index")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("what, app, kw", [
    # the main path's step and sweep, and the sweep of every built-in env
    # with continuous actions
    *(pytest.param(w, a, {}, id=f"{w}-{a}") for w, a in (
        ("train_step", "cartpole"), ("sweep", "cartpole"),
        ("sweep", "pendulum"), ("sweep", "mountaincar"),
        ("sweep", "predator_prey"), ("sweep", "glider"))),
    # each learner's step and sweep on its app, each prioritized draw
    # inside the step, and the commit under each other episode filter
    *(pytest.param(w, PATHS[p][0], PATHS[p][1], id=f"{w}-{p}")
      for p in LEARNERS for w in ("train_step", "sweep")),
    *(pytest.param("train_step", PATHS[p][0], PATHS[p][1],
                   id=f"train_step-{p}")
      for p in ("PERrank", "PERerr", "PERseq")),
    *(pytest.param("sweep", "cartpole", dict(ERoldSeqFilter=f),
                   id=f"sweep-{f}")
      for f in ("farpolfrac", "maxkldiv", "minerror")),
    # the BPTT step and the sweep that threads the acting carry
    *(pytest.param(w, PATHS[p][0], PATHS[p][1], id=f"{w}-{p}")
      for p in (*RECURRENT, *RECURRENT_MORE)
      for w in ("train_step", "sweep")),
])
def test_no_host_reads(what, app, kw):
    env = launch.env_module(app)
    tr = Trainer(env, env.MDP, HyperParameters(**dict(CFG, **kw)),
                 n_envs=N_ENVS, n_slots=N_SLOTS, max_len=MAX_LEN,
                 device="cpu", graphs=True)
    tr.warmup(chunk=16, blind_sweeps=16)
    tr._train_chunk(2)            # the static buffers and their first use
    mode = _HostReads()
    with mode:
        if what == "train_step":
            tr._train_chunk(1)
        else:
            tr._sweep(1)
    assert not mode.seen, mode.seen


def _cycle(tr, n_train, pre=None):
    logs = tr._sweep(1)
    return tr._train_chunk(n_train, pre=pre), logs


def _pinned(tr):
    """(ep, t) [N_ENVS, B] at stored steps, from a CPU generator."""
    g = torch.Generator().manual_seed(7)
    lens = tr.replay.slot_len.clone()
    ep = torch.randint(0, N_SLOTS, (N_ENVS, CFG["batchSize"]), generator=g,
                       dtype=torch.int32)
    ep = torch.where(tr.replay.slot_id[ep.long()] >= 0, ep,
                     torch.argmax(lens).to(torch.int32))
    t = (torch.rand(ep.shape, generator=g) * lens[ep.long()]).to(torch.int32)
    return ep, t


@pytest.mark.parametrize("what", ["fused", "long_chunk", *LEARNERS,
                                  "dqn_eps_greedy", "dqn_refer_retrace",
                                  "PERrank", "PERerr", "PERseq",
                                  "naf_PERerr", *RECURRENT,
                                  *RECURRENT_MORE])
def test_static_cycle_equals_eager_loop(what):
    """"fused": V-RACER's two fused cycles (the first on pinned
    presamples) and a third after the refresh; every other path the same
    cycles (a prioritized sampler's first on the step graph of pinned
    rows, the others on the one that draws inside the step);
    "long_chunk": a chunk longer than the static buffers."""
    path = "vracer" if what in ("fused", "long_chunk") else what
    eager, static = (_path_trainer(path, graphs=g) for g in (False, True))
    outs = []
    for tr in (eager, static):
        tr.warmup(chunk=16)
        if what == "long_chunk":
            outs.append([(tr._train_chunk(250), ())])
            continue
        outs.append([_cycle(tr, N_ENVS, pre=_pinned(tr)),
                     _cycle(tr, N_ENVS)])
        tr._update_replay(tr._refresh, 1000.0)
        outs[-1].append(_cycle(tr, N_ENVS))
    _assert_same_state(eager, static)
    # a prioritized sampler's trainer also built the step that draws
    assert sorted(static._step_graphs) == (
        [False, True] if "PER" in what else [True])
    for (ma, la), (mb, lb) in zip(*outs, strict=True):
        assert list(ma) == list(mb)
        for k in ma:
            assert ma[k].shape == (250 if what == "long_chunk" else N_ENVS,)
            assert torch.equal(ma[k], mb[k]), k
        for x, y in zip(la, lb, strict=True):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kw", [
    dict(nnType="GRU", nnBPTTseq=4),
    dict(learner="ACER"),
    dict(nnType="LSTM", nnBPTTseq=4),
    dict(learner="VRACER", ESpopSize=4),
    dict(learner="PPO"),
    dict(learner="DQN", nnType="LSTM", nnBPTTseq=4),
])
def test_graphs_only_for_capturable_learners(kw):
    """The learners without a captured step refuse graphs=True; V-RACER
    with a recurrent net has one, and its static cycle equals the eager
    one over a fused cycle."""
    app = "cartpole_discrete" if kw.get("learner") == "DQN" else "cartpole"
    assert not _trainer(app=app, **kw).graphs
    assert not _trainer().graphs          # the CPU captures nothing
    if kw.get("learner", "VRACER") == "VRACER" and "nnType" in kw:
        trs = [_trainer(graphs=g, app="cartpole_pomdp", **kw)
               for g in (False, True)]
        assert trs[1].graphs and trs[1].algo.capturable
        for tr in trs:
            tr.warmup(chunk=16)
            _cycle(tr, N_ENVS)
        _assert_same_state(*trs)
        return
    with pytest.raises(ValueError, match="no captured step"):
        _trainer(graphs=True, app=app, **kw)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["vracer", *LEARNERS, "PERrank", "PERerr",
                                  "PERseq", *RECURRENT, *RECURRENT_MORE])
def test_captured_cycle_equals_eager_on_card(cuda, path, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    from smarties_tpu_torch.ops import cuda_lib
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime import graphs as cg

    eager, captured = (_path_trainer(path, cuda, g) for g in (False, None))
    assert captured.graphs and not eager.graphs
    n_cycles = cg.WARMUP_CALLS + 2
    for tr in (eager, captured):
        tr.warmup(chunk=16)
        cuda_lib.reset_launches()
        for _ in range(n_cycles):
            _cycle(tr, N_ENVS)
        tr._update_replay(tr._refresh, 1000.0)
        retrace = tr.algo.returns_mode != "none"
        assert rk.launches.get("retrace_sweep", 0) == \
            (n_cycles + 1) * retrace
        ckpt = str(tmp_path / f"{tr.graphs}.pt")
        tr.save(ckpt)
        _cycle(tr, N_ENVS)
        tr.restore(ckpt)
        _cycle(tr, N_ENVS)
    _assert_same_state(eager, captured)
    step_graph, = captured._step_graphs.values()
    assert step_graph.graph is not None
    assert captured._sweep_graphs[1].graph is not None

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        captured._train_chunk(8)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert names.count("cudaGraphLaunch") == 8
    assert names.count("cudaLaunchKernel") < 8 * 4


@pytest.mark.cuda
def test_capture_outlives_dropped_graphs(cuda):
    """A capture made while the collector runs at every allocation, after
    a trainer with captured graphs was dropped in a reference cycle (its
    graphs reach it through their programs), succeeds: freeing those
    graphs while another graph captures would void that capture."""
    import gc

    from smarties_tpu_torch.runtime import graphs as cg

    old = _path_trainer("racer", cuda)
    old.warmup(chunk=16)
    for _ in range(cg.WARMUP_CALLS + 1):
        _cycle(old, 2)
    assert old._step_graphs[True].graph is not None
    tr = _path_trainer("vracer", cuda)
    tr.warmup(chunk=16)
    for _ in range(cg.WARMUP_CALLS):
        _cycle(tr, 1)
    del old
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)         # collect at every allocation
    try:
        _cycle(tr, 1)                 # the step graph's capture
    finally:
        gc.set_threshold(*thresholds)
    assert tr._step_graphs[True].graph is not None

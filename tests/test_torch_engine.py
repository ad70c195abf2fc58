"""Port parity: the external-env Engine's parts, and a whole Engine run,
against the JAX package's (smarties_tpu/runtime/engine.py), with no
forked process.

- `_EpisodeAssembler.finalize` on the same event stream (terminal,
  truncated, longer than max_len): equal arrays.
- `spec_to_mdp` / `spec_to_mdps`: equal MDP fields, the state box and
  per-agent overrides included; the twin of
  test_engine_features.py::test_state_scales_seed_standardization.
- `_LearnerBundle.commit` of seeded episodes (ragged lengths, terminal
  and truncated) into bundles that start from the same weights and
  replay (`engine_snapshot_from_jax`), before and after the statistics
  start (so the rewards are scaled); the JAX side runs K1 in interpret
  mode on the CPU, the port its plain version.
- Four `train_to_pace` steps with the (ep, t) samples injected through
  `sample_indices`, against the JAX learner's train_step(sample_override)
  on the same replay.
- The eval-mode act (train=False) on the same observations and the
  acting contexts of an LSTM learner advanced for the ready lanes only.
- A snapshot round trip through checkpoint.pt.
- Whole-Engine parity: both Engines serve the same episodes of
  apps/cart_pole_py's CartPole (pinned resets, an in-process lockstep
  pool) in eval mode from the same weights: the JAX one restored from a
  checkpoint.pkl, the port from the converted checkpoint.pt. The obs.raw
  and cumulative_rewards.dat files agree row for row.

Tolerances: the assembler and the MDP fields exact. The replay after
commits rtol 1e-5 / atol 1e-6 on returns (K1 against the Pallas kernel
in interpret mode: the same recursion in f32), exact elsewhere; after
the statistics start atol 2e-3 on the values and returns (V passes
through scale_net2v, test_torch_vracer.py). The train steps use the
learner tolerances of tests/_torch_learner_cases.py (params rtol 1e-5 /
atol 1e-7). The act: actions and mu rtol 1e-4 / atol 1e-5, values atol
2e-3. The whole Engine: the same rows, episode lengths and statuses;
states and rewards atol 1e-4 (the actions differ by f32 rounding, which
the cart-pole's unstable pole grows over an episode).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smarties_tpu
from smarties_tpu.runtime import communicator as jcomm
from smarties_tpu.runtime import engine as jeng
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.runtime import communicator as tcomm
from smarties_tpu_torch.runtime import engine as teng
from smarties_tpu_torch.runtime.trainer import _plain
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_engine_pools import (LockstepPool, PinnedCartPole,
                                 cart_pole_spec)
from _torch_learner_cases import PARAM_TOL
from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, np32, tn)

MAX_LEN, B = 32, 16
CFG = dict(minTotObsNum=48, maxTotObsNum=512, batchSize=B,
           nnLayerSizes=[16, 16], randSeed=0)
RET_TOL = dict(rtol=1e-5, atol=1e-6)
VALUE_TOL = dict(rtol=1e-4, atol=2e-3)
POLICY_TOL = dict(rtol=1e-4, atol=1e-5)


def _stream(rng, T, dim_s, dim_a, dim_p):
    """The add_state / add_action calls of one T-step episode."""
    calls = [("add_state", np32(rng.randn(dim_s)), 0.0)]
    for _ in range(T):
        calls.append(("add_action", np32(rng.randn(dim_a)),
                      np32(rng.rand(dim_p)), float(rng.randn()),
                      float(rng.randn())))
        calls.append(("add_state", np32(rng.randn(dim_s)),
                      float(rng.randn())))
    return calls


@pytest.mark.parametrize("T,terminal", [(7, True), (MAX_LEN - 1, False),
                                        (MAX_LEN + 5, False)])
def test_episode_assembler_finalize(T, terminal):
    rng = np.random.RandomState(T)
    calls = _stream(rng, T, 5, 2, 4)
    out = []
    for cls in (jeng._EpisodeAssembler, teng._EpisodeAssembler):
        asm = cls()
        for name, *args in calls:
            getattr(asm, name)(*args)
        out.append(asm.finalize(terminal, MAX_LEN))
        assert asm.obs == [] and asm.acts == []
    (*want, wT, wterm, wret), (*got, gT, gterm, gret) = out
    assert (gT, gterm, gret) == (wT, wterm, wret) == (min(T, MAX_LEN),
                                                      terminal, wret)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


_BOX = {"dim_state": 3, "dim_action": 1, "bounded": (True,),
        "upper": (1.0,), "lower": (-1.0,), "discrete_values": (),
        "observable": (True, False, True), "n_agents": 1,
        "n_appended_obs": 0, "agent_overrides": {},
        "different_mdps": False,
        "state_upper": (2.0, 9.0, 4.0), "state_lower": (-2.0, -9.0, 0.0)}
_TWO_AGENTS = {"dim_state": 2, "dim_action": 1, "bounded": (True,),
               "upper": (1.0,), "lower": (-1.0,), "discrete_values": (),
               "observable": None, "n_agents": 2, "n_appended_obs": 2,
               "different_mdps": True, "shared_noise": True,
               "agent_overrides": {1: {"dim_state": 3, "dim_action": 1,
                                       "discrete_values": (3,)}}}
_CART_POLE = {"dim_state": 6, "dim_action": 1, "bounded": (True,),
              "upper": (10.0,), "lower": (-10.0,), "discrete_values": (),
              "observable": (True, True, False, True, True, True),
              "n_agents": 1, "n_appended_obs": 0, "agent_overrides": {},
              "different_mdps": False}
_FIELDS = ("dim_state", "dim_action", "bounded", "upper_action",
           "lower_action", "discrete_values", "observable", "n_appended_obs",
           "conv_layers", "n_agents_per_env", "shared_noise", "state_upper",
           "state_lower", "dim_state_observed", "dim_net_input", "dim_policy",
           "is_discrete", "max_action_label")


@pytest.mark.parametrize("spec", [_BOX, _TWO_AGENTS, _CART_POLE],
                         ids=["state_box", "two_agents", "cart_pole"])
def test_spec_to_mdp(spec):
    want, got = jcomm.spec_to_mdps(spec), tcomm.spec_to_mdps(spec)
    assert len(got) == len(want) == (2 if spec["different_mdps"] else 1)
    for j, t in zip(want, got):
        for f in _FIELDS:
            assert getattr(t, f) == getattr(j, f), f
        if j.state_stats_init is None:
            assert t.state_stats_init is None
        else:
            for w, g in zip(j.state_stats_init, t.state_stats_init):
                np.testing.assert_array_equal(g, w)
    for agent in range(spec["n_agents"]):
        j, t = (m.spec_to_mdp(spec, agent) for m in (jcomm, tcomm))
        assert all(getattr(t, f) == getattr(j, f) for f in _FIELDS)


def test_state_scales_seed_standardization():
    """setStateScales seeds state_mean/std until online stats warm up
    (Communicator.cpp:98-122)."""
    mdp = tcomm.spec_to_mdp(_BOX)
    b = teng._LearnerBundle(0, mdp, THP(**CFG), [0], 16, device="cpu")
    np.testing.assert_allclose(tn(b.rs.state_mean), [0.0, 2.0], atol=1e-6)
    np.testing.assert_allclose(tn(b.rs.state_std), [4.0, 4.0], atol=1e-6)
    np.testing.assert_allclose(tn(b.rs.state_scale), [0.25, 0.25],
                               atol=1e-6)


def _bundles(cfg=CFG, spec=_CART_POLE, n_lanes=1):
    """A JAX bundle and a port bundle from the JAX one's snapshot."""
    lanes = list(range(n_lanes))
    jb = jeng._LearnerBundle(0, jcomm.spec_to_mdp(spec), JHP(**cfg), lanes,
                             MAX_LEN)
    tb = teng._LearnerBundle(0, tcomm.spec_to_mdp(spec), THP(**cfg), lanes,
                             MAX_LEN, device="cpu")
    tb.restore(convert.engine_snapshot_from_jax(
        dict(jb.snapshot(), replay=jax_replay_views(jb.rs))))
    return jb, tb


def _episodes(seed, lengths, terminals, mdp):
    """Assembled episodes (ep_arrays, T, terminal) from seeded streams."""
    rng = np.random.RandomState(seed)
    out = []
    for T, term in zip(lengths, terminals):
        asm = teng._EpisodeAssembler()
        for name, *args in _stream(rng, T, mdp.dim_state_observed,
                                   mdp.dim_action, mdp.dim_policy):
            if name == "add_action":   # a valid Gaussian policy vector
                args[1] = np.concatenate([args[1][:1], 0.3 + args[1][1:]])
            getattr(asm, name)(*args)
        *arrs, T_, term_, _ = asm.finalize(term, MAX_LEN)
        out.append((arrs, T_, term_))
    return out


def _commit(jb, tb, episodes):
    for arrs, T, term in episodes:
        jb.commit(arrs, T, term)
        tb.commit(arrs, T, term)
        jb.n_env_steps += T
        tb.n_env_steps += T


def _committed_pair():
    """Both bundles after 3 episodes, the statistics start, 3 more."""
    jb, tb = _bundles()
    mdp = tb.mdp
    _commit(jb, tb, _episodes(0, (23, 9, MAX_LEN), (True, False, False),
                              mdp))
    first = (jb.rs, convert.replay_to_numpy(tb.rs))
    for b in (jb, tb):
        b.maybe_init_stats()
        assert b.initialized and b.start_env_steps == 23 + 9 + MAX_LEN
    _commit(jb, tb, _episodes(1, (17, 30, 5), (False, True, True), mdp))
    return jb, tb, first


def test_commit_parity():
    jb, tb, (rs0_jax, rs0_port) = _committed_pair()
    # before the statistics start: unit scaling, the returns of K1
    views = jax_replay_views(rs0_jax)
    for k, w in views.items():
        tol = RET_TOL if k in ("qret",) else dict(rtol=0, atol=0)
        np.testing.assert_allclose(rs0_port[k], w, err_msg=k, **tol)
    assert int(np.sum(views["ep_id"] >= 0)) == 3
    # after: the rewards scaled, the values of the replayed states
    assert_replay_close(jb.rs, tb.rs, fields=("qret", "value", "v_trunc",
                                              "rew_mean", "rew_std",
                                              "rew_scale", "state_mean",
                                              "state_std", "state_scale"),
                        **VALUE_TOL)
    assert_replay_close(jb.rs, tb.rs, fields=(
        "states", "rewards", "actions", "mus", "rho", "advantage", "length",
        "ep_id", "terminal", "n_seen_eps", "n_seen_steps", "n_pruned_eps"),
        rtol=0, atol=0)
    assert float(jnp.abs(jb.rs.rew_scale - 1.0)) > 1e-3   # really scaled
    assert tb.n_committed_steps == int(tb.rs.n_seen_steps) == int(
        jb.rs.n_stored_steps())


def _pinned(rs_views, seed, n):
    """n steps of B distinct (ep, t) pairs of stored transitions."""
    rng = np.random.RandomState(seed)
    lens, valid = rs_views["length"], np.nonzero(rs_views["ep_id"] >= 0)[0]
    eps, ts = [], []
    for _ in range(n):
        pairs = set()
        while len(pairs) < B:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, lens[e]))))
        e, t = zip(*sorted(pairs))
        eps.append(e)
        ts.append(t)
    return np.asarray(eps, np.int32), np.asarray(ts, np.int32)


def test_train_to_pace_parity():
    jb, tb, _ = _committed_pair()
    ep, t = _pinned(jax_replay_views(jb.rs), 4, 4)
    asked = []

    def pinned(n):
        asked.append(n)
        return torch.as_tensor(ep[:n]), torch.as_tensor(t[:n])

    tb.sample_indices = pinned
    tb.start_env_steps = tb.n_env_steps - 4   # four steps owed
    tb.train_to_pace(10 ** 6)
    assert asked == [4] and tb.n_grad == 4
    tb.train_to_pace(10 ** 6)           # the pace is kept: nothing more
    assert asked == [4] and tb.n_grad == 4
    p, o, r = jb.params, jb.opt_state, jb.rs
    step = jax.jit(jb.algo.train_step)
    for i in range(4):
        p, o, r, _ = step(
            p, o, r, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(ep[i]), jnp.asarray(t[i])))
    assert_tree_close(tb.params, jax.device_get(p), **PARAM_TOL)
    assert_replay_close(r, tb.rs, fields=("rho", "kl"), **POLICY_TOL)
    assert_replay_close(r, tb.rs, fields=("delta", "value"), **VALUE_TOL)


@pytest.mark.parametrize("nn", ["FFNN", "LSTM"])
def test_eval_act_parity(nn):
    """bTrain == 0: the mean action. The LSTM's contexts advance only for
    the ready lanes, by an index copy."""
    extra = dict(nnType="LSTM", nnBPTTseq=4) if nn == "LSTM" else {}
    jb, tb = _bundles(dict(CFG, bTrain=False, **extra), n_lanes=4)
    rng = np.random.RandomState(7)
    obs = np32(rng.randn(4, 5))
    std = (jnp.asarray(obs) - jb.rs.state_mean) * jb.rs.state_scale
    want = jb.act_jit(jb.params, std, jax.random.PRNGKey(0), jb.rnn)
    rnn0 = [x.clone() for x in jax.tree_util.tree_leaves(tb.rnn)] \
        if nn == "LSTM" else []
    ready = [0, 2]
    env_a, a, mu, v, adv = tb.split_act(tb.act(obs, ready))
    np.testing.assert_allclose(a, np.asarray(want[0]), **POLICY_TOL)
    np.testing.assert_allclose(mu, np.asarray(want[1]), **POLICY_TOL)
    np.testing.assert_allclose(v, np.asarray(want[2]), **VALUE_TOL)
    np.testing.assert_allclose(adv, np.asarray(want[3]), **VALUE_TOL)
    np.testing.assert_allclose(
        env_a, np.asarray(jb.mdp.learner_to_env_action(want[0])),
        **POLICY_TOL)
    if nn == "LSTM":
        for got, new, old in zip(jax.tree_util.tree_leaves(tb.rnn),
                                 jax.tree_util.tree_leaves(want[4]), rnn0):
            np.testing.assert_allclose(tn(got)[ready],
                                       np.asarray(new)[ready], **POLICY_TOL)
            np.testing.assert_array_equal(tn(got)[[1, 3]], tn(old)[[1, 3]])
        assert any(np.abs(tn(x)).sum() > 0
                   for x in jax.tree_util.tree_leaves(tb.rnn))
        tb.reset_rnn_lane(2)
        assert all(not tn(x)[2].any()
                   for x in jax.tree_util.tree_leaves(tb.rnn))


def test_snapshot_roundtrip(tmp_path):
    """checkpoint.pt: the snapshot saved, loaded with weights_only and
    restored into a fresh bundle gives back every tensor and counter."""
    _, tb, _ = _committed_pair()
    tb.start_env_steps = tb.n_env_steps - 4
    tb.train_to_pace(10 ** 6)
    path = str(tmp_path / "checkpoint.pt")
    torch.save({"learners": [tb.snapshot()]}, path)
    snap = torch.load(path, weights_only=True)["learners"][0]
    fresh = teng._LearnerBundle(0, tb.mdp, tb.cfg, [0], MAX_LEN,
                                device="cpu")
    fresh.restore(snap)
    for tree in (lambda b: b.params, lambda b: _plain(b.opt_state)):
        got, want = tree_leaves(tree(fresh)), tree_leaves(tree(tb))
        assert len(got) == len(want) > 0
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for f in tb.rs.__dataclass_fields__:
        assert torch.equal(getattr(fresh.rs, f), getattr(tb.rs, f)), f
    for k in ("n_grad", "n_env_steps", "initialized", "start_env_steps"):
        assert getattr(fresh, k) == getattr(tb, k), k
    assert fresh.n_grad == 4 and fresh.initialized


def _read_obs(path):
    raw = np.fromfile(path, np.float32)
    return raw.reshape(-1, 2 + 6 + 1)      # [lane, status, state, reward]


def test_whole_engine_eval_parity(tmp_path):
    """Both Engines in eval mode from the same weights serve the same
    CartPole episodes: the obs and rewards files agree row for row."""
    cfg = dict(CFG, bTrain=False)
    jb = jeng._LearnerBundle(0, jcomm.spec_to_mdp(cart_pole_spec(
        jcomm.Communicator)), JHP(**cfg), [0, 1], 64)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, tdir):
        d.mkdir()
    with open(jdir / "checkpoint.pkl", "wb") as f:
        pickle.dump({"learners": [jb.snapshot()]}, f)
    torch.save({"learners": [convert.engine_snapshot_from_jax(
        dict(jb.snapshot(), replay=jax_replay_views(jb.rs)))]},
        tdir / "checkpoint.pt")
    for pkg, comm, d in ((smarties_tpu, jcomm, jdir),
                         (None, tcomm, tdir)):
        pool = LockstepPool(cart_pole_spec(comm.Communicator),
                            [PinnedCartPole(s) for s in (11, 12)],
                            comm.spec_to_mdp, comm.spec_to_mdps)
        if pkg is None:
            e = teng.Engine(["prog", "--nEvalEpisodes", "3", "--runDir",
                             str(d), "--device", "cpu"])
            assert not e.parse() and e.device == "cpu"
            assert e.restart_path == str(d / "checkpoint.pt")
            e.setSettings(THP(**cfg))
        else:
            e = pkg.Engine(["prog", "--nEvalEpisodes", "3", "--runDir",
                            str(d)])
            assert not e.parse()
            e.setSettings(JHP(**cfg))
        e.setMaxEpisodeLength(64)
        e.run(None, pool=pool, max_wall_s=120)
        assert pool.killed and e.n_grad_steps == 0
        assert not (d / "checkpoint.pt.tmp").exists()
    want = _read_obs(jdir / "agent_00_rank00_obs.raw")
    got = _read_obs(tdir / "agent_00_rank00_obs.raw")
    assert got.shape == want.shape and len(want) > 20
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=0, atol=1e-5)
    rw = np.loadtxt(jdir / "agent_00_rank00_cumulative_rewards.dat",
                    ndmin=2)
    rt = np.loadtxt(tdir / "agent_00_rank00_cumulative_rewards.dat",
                    ndmin=2)
    assert rt.shape == rw.shape and len(rw) >= 3
    np.testing.assert_array_equal(rt[:, :4], rw[:, :4])
    np.testing.assert_allclose(rt[:, 4], rw[:, 4], rtol=0, atol=1e-5)

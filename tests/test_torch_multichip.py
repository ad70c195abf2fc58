"""Port parity: the learner mesh (parallel/mesh.py) against the JAX
package's shard_map over the "learners" axis.

The port runs one process per learner rank: here K ranks spawned by
tests/_torch_mesh_worker.py, joined by gloo through a file store under
tmp_path, one torch thread each. Inputs go to the ranks as numpy files
and their results come back the same way. The JAX side runs in this
process on conftest's 8 virtual CPU devices. All of it stays in this one
file, so that `--dist loadfile` keeps its processes on one xdist worker.

A gloo ring sum adds in another order than XLA's psum, so the parity is
to a tolerance: the twin of test_grad_parity_1dev_vs_4dev_exact keeps
its rtol 2e-5 / atol 2e-6; the learners keep the tolerances of
_torch_learner_cases.py (test_torch_racer_es.py's POP_TOL for RACER-ES,
test_torch_acer.py's for ACER). The rebalance moves records: exact.
Across the port's ranks the replicated state is compared exactly.
Every case ends on a count or an event, never on a wall-clock bound;
each process group times out after _torch_mesh_worker.TIMEOUT_S.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from smarties_tpu.algos.base import default_metrics as j_default_metrics
from smarties_tpu.algos.base import post_step_processing as j_post_step
from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.envs import cartpole as jc
from smarties_tpu.ops import continuous_policy as jcp
from smarties_tpu.parallel.mesh import AXIS, make_mesh, replay_pspec
from smarties_tpu.replay import buffer as jrb
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos.vracer import VRacer
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_mesh_worker import flatten, spawn, to_plain, unflatten
from _torch_parity import jax_replay_views, np32, tn, tt
from _torch_learner_cases import (BASE, MOMENT_TOL, MOMENT_TOL_RNN,
                                  PARAM_TOL, POLICY_TOL, RAW_VALUE_TOL,
                                  VALUE_TOL, _jax_replay)

GRAD_TOL = dict(rtol=2e-5, atol=2e-6)     # tests/test_multichip.py:110-111
PER_SLOT = ("states", "rewards", "actions", "mus", "qret", "rho", "kl",
            "delta", "value", "advantage", "length", "ep_id", "terminal",
            "far_count", "qret_stale", "v_trunc")
SCALARS = ("beta", "alpha", "cmax_ret", "cinv_ret", "state_mean",
           "state_std", "state_scale", "rew_mean", "rew_std", "rew_scale",
           "n_seen_eps", "n_seen_steps", "n_pruned_eps", "max_abs_error")


def _sharded(fn, K, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=make_mesh(K), in_specs=in_specs,
                             out_specs=out_specs, check_vma=False))


def _per_device(x, K):
    """Each device's own buffer of a P() output (shard_map with
    check_vma=False does not make them agree), in mesh order."""
    devs = list(make_mesh(K).devices.flat)
    return [np.asarray(s.data) for s in sorted(
        x.addressable_shards, key=lambda s: devs.index(s.device))]


def _jax_shards(rs, K):
    """{field: [K per-shard numpy views]} of a sharded JAX replay."""
    out = {}
    for f in PER_SLOT:
        x = np.asarray(getattr(rs, f))
        out[f] = list(x.reshape((K, -1) + x.shape[1:]))
    for f in SCALARS:
        out[f] = _per_device(getattr(rs, f), K)
    return out


def _close(got, want, tol, msg):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    if tol is None or want.dtype == bool or np.issubdtype(want.dtype,
                                                         np.integer):
        np.testing.assert_array_equal(got, want, err_msg=msg)
    else:
        np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _same_on_ranks(outs, prefixes):
    """The replicated state is bit-equal on every rank."""
    for k in outs[0]:
        if k.startswith(prefixes):
            for r, o in enumerate(outs[1:], 1):
                np.testing.assert_array_equal(o[k], outs[0][k],
                                              err_msg=f"rank {r}: {k}")


# ---------------------------------------------------------------------------
# 1. the twin of test_grad_parity_1dev_vs_4dev_exact
# ---------------------------------------------------------------------------

def test_grad_parity_1rank_vs_4ranks(tmp_path):
    """The same global batch of pinned (episode, t) samples, split over 4
    ranks whose shards hold the owning episodes, gives the parameters of
    one process holding everything, and of JAX's 4-device shard_map."""
    K, B = 4, 32
    cfg = dict(minTotObsNum=512, maxTotObsNum=2048, batchSize=B,
               obsPerStep=1.0, nnLayerSizes=[32, 32], randSeed=7)
    jl = jmake(jc.MDP, JHP(**cfg))
    params, opt = jl.init(jax.random.PRNGKey(0))
    n_slots, max_len, dimS = 16, 32, jc.MDP.dim_state_observed
    L1 = max_len + 1
    rng = np.random.RandomState(0)
    rs = jrb.init_replay(n_slots, max_len, dimS, 1, 2, jl.cfg.clipImpWeight,
                         mu_init=jrb.safe_mu(jc.MDP))
    rs = rs._replace(
        ep_id=jnp.arange(n_slots, dtype=jnp.int32),
        length=jnp.full((n_slots,), 20, jnp.int32),
        states=jnp.asarray(np32(rng.randn(n_slots, L1, dimS) * 0.3)),
        actions=jnp.asarray(np32(rng.randn(n_slots, L1, 1) * 0.5)),
        mus=jnp.asarray(np.concatenate(
            [np32(rng.randn(n_slots, L1, 1) * 0.3),
             np.ones((n_slots, L1, 1), np.float32)], -1)),
        rewards=jnp.asarray(np32(rng.randn(n_slots, L1) * 0.1)),
        rho=jnp.ones((n_slots, L1)),
        qret=jnp.asarray(np32(rng.randn(n_slots, L1) * 0.2)))
    ep_local = rng.randint(0, n_slots // K, (K, B // K)).astype(np.int32)
    t_pin = rng.randint(0, 19, (K, B // K)).astype(np.int32)
    ep_global = (ep_local + np.arange(K, dtype=np.int32)[:, None]
                 * (n_slots // K)).reshape(-1)
    key = jax.random.PRNGKey(99)

    j1 = jax.jit(lambda p, o, r: jl.train_step(
        p, o, r, key, sample_override=(jnp.asarray(ep_global),
                                       jnp.asarray(t_pin.reshape(-1)))))(
        params, opt, rs)[0]
    j4 = _sharded(lambda p, o, r, e, t: jl.train_step(
        p, o, r, key, axis_name=AXIS,
        sample_override=(e.reshape(-1), t.reshape(-1)))[0],
        K, (P(), P(), replay_pspec(rs), P(AXIS), P(AXIS)), P())(
        params, opt, rs, jnp.asarray(ep_local[:, None]),
        jnp.asarray(t_pin[:, None]))

    # the port on one process
    tl = VRacer(tc.MDP, THP(**cfg))
    views = jax_replay_views(rs)
    tp, _, _, _ = tl.train_step(
        convert.params_from_jax(jax.device_get(params)),
        convert.opt_state_from_jax(jax.device_get(opt)),
        convert.replay_from_jax(views),
        sample_override=(tt(ep_global, torch.int32),
                         tt(t_pin.reshape(-1), torch.int32)))
    p1 = flatten(convert.params_to_jax(tp), "p")

    inputs = dict(flatten(jax.device_get(params), "p"),
                  **flatten(to_plain(jax.device_get(opt)), "o"),
                  **flatten(views, "rs"),
                  **{"ep/0": ep_local, "t/0": t_pin})
    outs = spawn("pinned_steps", K, tmp_path, inputs, dict(
        cfg=dict(cfg, learner="VRACER"), discrete=False, n_steps=1))
    _same_on_ranks(outs, ("p/", "o/"))
    want1, want4 = (flatten(jax.device_get(x), "p") for x in (j1, j4))
    for k in p1:
        _close(outs[0][k], p1[k], GRAD_TOL, "port 4 ranks vs 1: " + k)
        _close(outs[0][k], want4[k], GRAD_TOL, "port vs JAX 4 dev: " + k)
        _close(p1[k], want1[k], GRAD_TOL, "port vs JAX 1 dev: " + k)
    # the step moved the parameters
    assert max(np.abs(p1[k] - flatten(jax.device_get(params), "p")[k]).max()
               for k in p1) > 0


# ---------------------------------------------------------------------------
# 2. the twin of TestRebalance::test_ring_rebalance_fills_empty_shard
# ---------------------------------------------------------------------------

def test_ring_rebalance_matches_jax_shard_for_shard(tmp_path):
    """An empty shard next to a loaded one receives episodes; after each
    of 3 rebalances every rank's shard is JAX's shard, exactly."""
    K, n_slots, max_len, rounds = 4, 32, 16, 3
    rng = np.random.RandomState(1)
    rs = jrb.init_replay(n_slots, max_len, 3, 1, 2, 4.0)
    loaded = np.arange(n_slots) < 8          # shard 0 full, the rest empty
    L1 = max_len + 1
    rs = rs._replace(
        ep_id=jnp.asarray(np.where(loaded, np.arange(n_slots), -1),
                          jnp.int32),
        length=jnp.asarray(np.where(loaded, 6 + np.arange(n_slots) % 5, 0),
                           jnp.int32),
        states=jnp.asarray(np32(rng.randn(n_slots, L1, 3))),
        rewards=jnp.asarray(np32(rng.randn(n_slots, L1))),
        qret=jnp.asarray(np32(rng.randn(n_slots, L1))),
        kl=jnp.asarray(np32(rng.rand(n_slots, L1))),
        rho=jnp.ones((n_slots, L1)))
    f = _sharded(lambda r: jrb.rebalance_shards(r, AXIS, k_max=4,
                                                max_tot_obs=10 ** 6),
                 K, (replay_pspec(rs),), replay_pspec(rs))
    outs = spawn("rebalance", K, tmp_path, flatten(jax_replay_views(rs),
                                                   "rs"),
                 dict(rounds=rounds, k_max=4, max_tot_obs=10 ** 6))
    counts = []
    for i in range(rounds):
        rs = f(rs)
        want = _jax_shards(rs, K)
        for r in range(K):
            got = unflatten(outs[r], f"round{i}")
            for field in PER_SLOT + SCALARS:
                _close(got[field], want[field][r], None,
                       f"round {i} rank {r}: {field}")
        counts.append([int((w >= 0).sum()) for w in want["ep_id"]])
    assert counts[0][0] < 8 and counts[0][1] > 0, counts
    assert all(sum(c) == 8 for c in counts), counts   # none lost or doubled
    assert int(np.asarray(rs.length).sum()) == int(
        np.where(loaded, 6 + np.arange(n_slots) % 5, 0).sum())


# ---------------------------------------------------------------------------
# 3. the replay statistics and per-step bookkeeping under the mesh
# ---------------------------------------------------------------------------

STATS_CFG = dict(batchSize=32, maxTotObsNum=200, minTotObsNum=64,
                 penalTol=0.1, clipImpWeight=4.0, epsAnneal=5e-7)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def stats_runs(tmp_path_factory):
    """The JAX functions under a 4-device shard_map and the port's under
    4 ranks, on one random replay whose shards differ."""
    K, n_slots, max_len, dimS, Bk = 4, 32, 12, 3, 8
    rng = np.random.RandomState(2)
    L1 = max_len + 1
    valid = rng.rand(n_slots) > 0.2
    lens = np.where(valid, rng.randint(1, max_len + 1, n_slots), 0)
    rs = jrb.init_replay(n_slots, max_len, dimS, 1, 2, 4.0)
    rs = rs._replace(
        ep_id=jnp.asarray(np.where(valid, np.arange(n_slots), -1),
                          jnp.int32),
        length=jnp.asarray(lens, jnp.int32),
        states=jnp.asarray(np32(rng.randn(n_slots, L1, dimS) * 2 + 1)),
        rewards=jnp.asarray(np32(rng.randn(n_slots, L1) + 0.5)),
        rho=jnp.asarray(np32(np.exp(rng.randn(n_slots, L1)))),
        far_count=jnp.asarray(np32(rng.randint(0, 5, n_slots))),
        max_abs_error=jnp.float32(0.3))
    step = 17
    per = {"delta_q": np32(rng.randn(K, Bk)), "dkl": np32(rng.rand(K, Bk)),
           "rho": np32(np.exp(rng.randn(K, Bk))),
           "is_far": rng.rand(K, Bk) > 0.7, "v_val": np32(rng.randn(K, Bk))}
    lr = 0.3
    cfg = JHP(**STATS_CFG)
    sp = replay_pspec(rs)
    want = {}
    r1, frac = _sharded(lambda r: jrb.update_beta_alpha(
        r, cfg.batchSize, cfg.maxTotObsNum, cfg.penalTol, AXIS), K, (sp,),
        (sp, P()))(rs)
    want.update({"beta_alpha/beta": r1.beta, "beta_alpha/alpha": r1.alpha,
                 "beta_alpha/frac_off": frac})
    for tag, kw in (("lr", dict(learn_rate=lr)),
                    ("init", dict(learn_rate=1.0, b_init=True))):
        r2 = _sharded(lambda r: jrb.update_state_rew_stats(
            r, axis_name=AXIS, **kw), K, (sp,), sp)(rs)
        for f in ("state_mean", "state_std", "state_scale", "rew_mean",
                  "rew_std", "rew_scale"):
            want[f"stats/{tag}/{f}"] = getattr(r2, f)
            want[f"stats_chunked/{tag}/{f}"] = getattr(r2, f)
    r3, frac3 = _sharded(lambda r, d: j_post_step(
        r, cfg, jnp.int32(step), d.reshape(-1), AXIS), K, (sp, P(AXIS)),
        (sp, P()))(
        rs, jnp.asarray(per["delta_q"][:, None]))
    for f in ("beta", "alpha", "cmax_ret", "cinv_ret", "max_abs_error"):
        want["post_step/" + f] = getattr(r3, f)
    want["post_step/frac_off"] = frac3
    m = _sharded(lambda dkl, rho, far, dq, v: j_default_metrics(
        dkl.reshape(-1), rho.reshape(-1), far.reshape(-1), frac3, r3.beta,
        dq.reshape(-1), v.reshape(-1), AXIS),
        K, (P(AXIS),) * 5, P())(*(jnp.asarray(per[k][:, None]) for k in (
            "dkl", "rho", "is_far", "delta_q", "v_val")))
    want.update({"metrics/" + k: v for k, v in m.items()})
    want = {k: _per_device(v, K)[0] for k, v in want.items()}
    inputs = dict(flatten(jax_replay_views(rs), "rs"), **per)
    # a chunk of 2 time rows of the 8 slots x 3 dims of each shard
    outs = spawn("stats", K, tmp_path_factory.mktemp("stats"), inputs,
                 dict(cfg=STATS_CFG, lr=lr, opt_step=step,
                      chunk_elems=2 * (n_slots // K) * dimS))
    return want, outs


@pytest.mark.parametrize("what", ["beta_alpha", "stats", "stats_chunked",
                                  "post_step", "metrics"])
def test_stats_and_bookkeeping_under_mesh(stats_runs, what):
    want, outs = stats_runs
    keys = [k for k in want if k.startswith(what + "/")]
    assert keys
    _same_on_ranks(outs, (what + "/",))
    for k in keys:
        _close(outs[0][k], want[k], STATS_TOL, k)


# ---------------------------------------------------------------------------
# 4. 4 pinned steps of every learner under K = 2
# ---------------------------------------------------------------------------

PPO_CFG = dict(BASE, learner="PPO", clipImpWeight=0.2,
               encoderLayerSizes=[16], nnLayerSizes=[16], gamma=0.995,
               klDivConstraint=0.01, obsPerStep=6.4, epsAnneal=0.0,
               **{"lambda": 0.97})
ES_CFG = dict(BASE, learner="VRACER", batchSize=16, ESpopSize=6,
              clipImpWeight=4, explNoise=0.447214, gamma=0.995,
              learnrate=0.001, epsAnneal=0, outWeightsPrefac=0.01)
ACER_CFG = dict(BASE, learner="ACER", nnLayerSizes=[16],
                encoderLayerSizes=[16], clipImpWeight=5,
                explNoise=0.4472135955, gamma=0.995, targetDelay=1e-3,
                learnrate=1e-4)
# name: (discrete MDP?, settings)
LEARNERS = {
    "vracer": (False, dict(BASE, learner="VRACER")),
    "dqn": (True, dict(BASE, learner="DQN", clipImpWeight=4.0,
                       returnsEstimator="retrace", targetDelay=1e-3)),
    "naf": (False, dict(BASE, learner="NAF", returnsEstimator="retrace",
                        targetDelay=1e-3)),
    "dpg": (False, dict(BASE, learner="DPG", returnsEstimator="retrace",
                        encoderLayerSizes=[16], targetDelay=1e-3)),
    "mixedpg": (False, dict(BASE, learner="MixedPG")),
    "ppo": (False, PPO_CFG),
    "acer": (False, ACER_CFG),
    "racer_es": (False, ES_CFG),
    "vracer_lstm": (False, dict(BASE, learner="VRACER", nnType="LSTM",
                                nnBPTTseq=8)),
}
N_STEPS, K2 = 4, 2


def _pinned_local(rs, K, Bk, seed, acer):
    """Per step [K, Bk] local (ep, t) samples: distinct pairs inside each
    shard, half of them at t = T-1 (ACER: distinct episodes and raw
    window starts in [0, 2^30))."""
    rng = np.random.RandomState(seed)
    lens = np.asarray(rs.length).reshape(K, -1)
    ids = np.asarray(rs.ep_id).reshape(K, -1)
    steps = []
    for _ in range(N_STEPS):
        eps, ts = [], []
        for k in range(K):
            valid = np.nonzero(ids[k] >= 0)[0]
            if acer:
                ep = rng.choice(valid, Bk, replace=len(valid) < Bk)
                t = rng.randint(0, 2 ** 30, Bk)
            else:
                pairs = {(int(e), int(lens[k][e]) - 1)
                         for e in rng.choice(valid, Bk // 2, replace=False)}
                while len(pairs) < Bk:
                    e = int(rng.choice(valid))
                    pairs.add((e, int(rng.randint(0, lens[k][e]))))
                ep, t = (np.asarray(x) for x in zip(*sorted(pairs)))
            eps.append(ep)
            ts.append(t)
        steps.append((np.asarray(eps, np.int32), np.asarray(ts, np.int32)))
    return steps


def _jax_learner_run(name):
    """JAX's learner on the 2-device mesh: the start state, the pinned
    inputs each rank needs, and the state after N_STEPS sharded steps."""
    discrete, cfg = LEARNERS[name]
    jmdp = jc.discrete.MDP if discrete else jc.MDP
    jl = jmake(jmdp, JHP.from_dict(cfg))
    params, opt = jl.init(jax.random.PRNGKey(0))
    if name == "ppo":
        opt = opt._replace(dkl_target=jnp.float32(0.05))
    rs = jl.initialize_stats(_jax_replay(jmdp, jl.cfg.clipImpWeight))
    sp = replay_pspec(rs)
    # each shard's own sampling cache, as the sharded rollout keeps it
    rs = _sharded(jrb.rebuild_sample_cache, K2, (sp,), sp)(rs)
    es = name == "racer_es"
    Bk = jl.cfg.batchSize if es else jl.cfg.batchSize // K2
    inputs = dict(flatten(jax.device_get(params), "p"),
                  **flatten(to_plain(jax.device_get(opt)), "o"),
                  **flatten(jax_replay_views(rs), "rs"))
    if es:
        # the same key on both shards: each JAX shard resamples its
        # population from its key, and only a shared key keeps them equal
        step = _sharded(lambda p, o, r, k: jl.train_step(
            p, o, r, k, axis_name=AXIS), K2, (P(), P(), sp, P()),
            (P(), P(), sp, P()))
        draw = _sharded(lambda r, k: [x[None] for x in jrb.sample(
            jax.random.split(k)[0], r, Bk, "uniform")], K2, (sp, P()),
            P(AXIS))
    else:
        step = _sharded(lambda p, o, r, e, t, k: jl.train_step(
            p, o, r, k, axis_name=AXIS,
            sample_override=(e.reshape(-1), t.reshape(-1))),
            K2, (P(), P(), sp, P(AXIS), P(AXIS), P()), (P(), P(), sp, P()))
        pinned = _pinned_local(rs, K2, Bk, 2, name == "acer")
    jp, jo, jr, ms = params, opt, rs, []
    for i in range(N_STEPS):
        key = jax.random.PRNGKey(10 + i)
        if es:
            ep, t = (np.asarray(x) for x in draw(jr, key))
            n = params["pop"].shape[1]
            inputs[f"z/{i}"] = np.asarray(jax.random.normal(
                jax.random.split(key)[1], (jl.cfg.ESpopSize, n)))
            jp, jo, jr, m = step(jp, jo, jr, key)
        else:
            ep, t = pinned[i]
            jp, jo, jr, m = step(jp, jo, jr, jnp.asarray(ep[:, None]),
                                 jnp.asarray(t[:, None]), key)
        if name == "acer":
            # the clipped normals each JAX shard draws from its folded key
            S = min(200, rs.max_len)
            ks = [jax.random.split(jax.random.fold_in(key, k), 4)
                  for k in range(K2)]
            inputs[f"noise_pol/{i}"] = np.stack([np.asarray(
                jcp.clipped_normal(k[2], (Bk, S + 1, 1))) for k in ks])
            inputs[f"noise_ext/{i}"] = np.stack([np.asarray(
                jcp.clipped_normal(k[3], (5, Bk, S + 1, 1))) for k in ks])
        inputs[f"ep/{i}"], inputs[f"t/{i}"] = ep, t
        ms.append({k: _per_device(v, K2)[0] for k, v in m.items()})
    return dict(jl=jl, inputs=inputs, params=jax.device_get(jp),
                opt=to_plain(jax.device_get(jo)), rs=jr, metrics=ms,
                meta=dict(cfg=cfg, discrete=discrete, n_steps=N_STEPS))


@pytest.fixture(scope="module")
def learner_runs(tmp_path_factory):
    runs = {name: _jax_learner_run(name) for name in LEARNERS}
    inputs = {}
    for name, run in runs.items():
        inputs.update({name + ":" + k: v for k, v in run["inputs"].items()})
    outs = spawn("learners", K2, tmp_path_factory.mktemp("learners"),
                 inputs, dict(learners={n: r["meta"]
                                        for n, r in runs.items()}))
    return runs, outs


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_four_pinned_steps_under_mesh(learner_runs, name):
    runs, outs = learner_runs
    run = runs[name]
    got = [{k[len(name) + 1:]: v for k, v in o.items()
            if k.startswith(name + ":")} for o in outs]
    _same_on_ranks(got, ("p/", "o/adam/", "o/m1/", "o/m2/", "o/step",
                         "o/noise", "o/diag_cov", "o/path_cov",
                         "o/penal_coef", "o/dkl_target"))
    want_p = flatten(run["params"], "p")
    want_o = flatten(run["opt"], "o")
    rnn = LEARNERS[name][1].get("nnType", "FFNN") != "FFNN"
    moment_tol = MOMENT_TOL_RNN if rnn else MOMENT_TOL
    skip = ()
    if name == "acer":
        # the advantage net's output bias steps on rounding noise (its
        # gradient is 0 analytically): test_torch_acer.py holds it apart
        skip = ("p/net/advtg/out/b", "o/m1/advtg/out/b", "o/m2/advtg/out/b")
    tol_p = dict(rtol=1e-5, atol=1e-6) if name == "racer_es" else PARAM_TOL
    for k, w in want_p.items():
        if k not in skip:
            _close(got[0][k], w, tol_p, f"{name}: {k}")
    for k, w in want_o.items():
        if k in skip:
            continue
        tol = (moment_tol if "/m1/" in k or "/m2/" in k
               else dict(rtol=1e-5, atol=1e-6))
        _close(got[0][k], w, tol, f"{name}: {k}")
    assert int(np.asarray(got[0].get("o/step", got[0].get(
        "o/adam/step")))) == N_STEPS
    # each rank's replay shard against JAX's
    want_rs = _jax_shards(run["rs"], K2)
    value_tol = (VALUE_TOL if name.startswith(("vracer", "racer"))
                 else RAW_VALUE_TOL)
    for r in range(K2):
        rs = unflatten(got[r], "rs")
        for f, tol in (("rho", POLICY_TOL), ("kl", POLICY_TOL),
                       ("advantage", POLICY_TOL), ("delta", value_tol),
                       ("value", value_tol), ("far_count", None),
                       ("length", None), ("ep_id", None),
                       ("beta", dict(rtol=1e-5, atol=1e-7)),
                       ("alpha", dict(rtol=1e-5, atol=1e-7)),
                       ("cmax_ret", dict(rtol=1e-5, atol=1e-7)),
                       ("max_abs_error", value_tol)):
            _close(rs[f], want_rs[f][r], tol, f"{name} rank {r}: {f}")
    # rank 0's metrics (the global ones are the same on every rank)
    m = unflatten(got[0], "m")
    assert sorted(m) == sorted(run["metrics"][0])
    for k in m:
        tol = value_tol if k in ("avg_v", "rmse") else dict(rtol=1e-4,
                                                             atol=1e-6)
        _close(np.stack(m[k]), np.stack([x[k] for x in run["metrics"]]),
               tol, f"{name}: metric {k}")


# ---------------------------------------------------------------------------
# 5. the twin of test_8dev_train_runs: the sharded Trainer
# ---------------------------------------------------------------------------

TRAINER_CFG = dict(minTotObsNum=512, maxTotObsNum=2048, batchSize=32,
                   obsPerStep=1.0, nnLayerSizes=[32, 32])


@pytest.mark.parametrize("K", [2, 4])
def test_sharded_trainer_runs(tmp_path, K):
    """16 envs and 64 slots over K ranks, warmup and 50 grad steps: every
    rank ends with the same parameters and optimizer state, counts the
    same global stored steps and grad steps, and rank 0's rewards file
    holds episodes of every rank's lanes."""
    outs = spawn("trainer", K, tmp_path, meta=dict(
        cfg=TRAINER_CFG, n_envs=16, n_slots=64, max_len=64, steps=50,
        warmup_chunk=16))
    _same_on_ranks(outs, ("p/", "o/", "n_grad_steps", "n_env_steps",
                          "global_stored", "rs/beta", "rs/alpha",
                          "rs/state_", "rs/rew_"))
    o = outs[0]
    assert int(o["n_grad_steps"]) >= 50
    assert int(o["global_stored"]) == sum(
        int(x["rs/length"][x["rs/ep_id"] >= 0].sum()) for x in outs)
    assert int(o["global_stored"]) >= TRAINER_CFG["minTotObsNum"]
    assert all(np.isfinite(v).all() for k, v in o.items()
               if k.startswith("p/"))
    assert np.isfinite(o["rs/beta"])
    rows = np.loadtxt(os.path.join(tmp_path, "run",
                                   "agent_00_rank00_cumulative_rewards.dat"),
                      ndmin=2)
    lanes = set(rows[:, 2].astype(int))
    assert lanes <= set(range(16))
    assert {lane // (16 // K) for lane in lanes} == set(range(K))


@pytest.mark.slow
def test_four_rank_sharded_trainer(tmp_path):
    """The twin of test_multiprocess.py's 4-process case (the checksum
    check of tests/_mp_worker.py): 4 ranks, 32 envs, 200 grad steps from
    a cold start; bitwise-equal parameters and global counts."""
    outs = spawn("trainer", 4, tmp_path, meta=dict(
        cfg=dict(minTotObsNum=512, maxTotObsNum=4096, batchSize=64,
                 nnLayerSizes=[16, 16], obsPerStep=1.0),
        n_envs=32, n_slots=64, max_len=tc.MAX_STEPS, steps=200))
    _same_on_ranks(outs, ("p/", "o/", "n_grad_steps", "global_stored"))
    assert int(outs[0]["n_grad_steps"]) >= 200


# ---------------------------------------------------------------------------
# 6. a checkpoint of 2 ranks restores into 1 and back
# ---------------------------------------------------------------------------

def test_save_2_ranks_restore_1_and_back(tmp_path):
    meta = dict(cfg=dict(TRAINER_CFG, minTotObsNum=256), n_envs=8,
                n_slots=32, max_len=64, warmup_chunk=16, steps=20)
    saved = spawn("save", 2, tmp_path, meta=dict(meta, save="ck2.pt"))
    _same_on_ranks(saved, ("p/", "o/", "n_grad_steps", "n_env_steps"))

    # one process restores the 2-rank checkpoint
    tr = Trainer(tc, tc.MDP, THP.from_dict(meta["cfg"]), n_envs=8,
                 n_slots=32, max_len=64, device="cpu")
    tr.restore(os.path.join(tmp_path, "ck2.pt"))
    assert tr.n_grad_steps == int(saved[0]["n_grad_steps"])
    assert tr.n_env_steps == int(saved[0]["n_env_steps"])
    got_p = flatten(convert.params_to_jax(tr.params), "p")
    for k, v in got_p.items():
        np.testing.assert_array_equal(v, saved[0][k], err_msg=k)
    full = convert.replay_to_numpy(tr.replay)
    for f in PER_SLOT:
        np.testing.assert_array_equal(full[f], np.concatenate(
            [s["rs/" + f] for s in saved]), err_msg=f)
    for f in SCALARS:
        np.testing.assert_array_equal(full[f], saved[0]["rs/" + f],
                                      err_msg=f)
    # the sampling cache is the single-rank one
    assert int(tn(tr.replay.samp_csum[-1])) == int(
        tn(tr.replay.n_stored_steps()))
    tr.train(5, log_every=10 ** 9)          # and it trains on
    tr.save(os.path.join(tmp_path, "ck1.pt"))

    # ... and 2 ranks restore the single-process checkpoint
    back = spawn("restore", 2, tmp_path, meta=dict(
        meta, restore="ck1.pt", steps=10))
    after = convert.replay_to_numpy(tr.replay)
    for r, o in enumerate(back):
        for f in PER_SLOT:
            np.testing.assert_array_equal(
                o["restored/rs/" + f], np.split(after[f], 2)[r],
                err_msg=f"rank {r}: {f}")
        for k, v in flatten(convert.params_to_jax(tr.params), "p").items():
            np.testing.assert_array_equal(o["restored/" + k], v, err_msg=k)
        assert int(o["restored/n_grad_steps"]) == tr.n_grad_steps
    _same_on_ranks(back, ("p/", "o/", "n_grad_steps"))
    assert int(back[0]["n_grad_steps"]) >= tr.n_grad_steps + 10

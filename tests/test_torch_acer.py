"""Port parity: ACER (smarties_tpu_torch/algos/acer.py) against the JAX
package's (smarties_tpu/algos/acer.py).

A two-dimensional action space (one tanh-squashed dim, one not, so the
Retrace trace c = min(1, rho)^(1/sqrt 2) is not the clipped weight
itself) over 16 slots of synthetic episodes of 1..16 steps, half of them
terminal. The JAX package builds the learner, its params and Adam state
and a replay, initialises the statistics (ACER recomputes no returns
there); everything goes through smarties_tpu_torch.models.convert into
the port. Both then take 4 train steps on the same pinned draws: B
DISTINCT episodes per step (overlapping windows of one episode make the
scatter's winner undefined in both frameworks) with raw window starts,
and the two noises that JAX's step draws from split(key, 4). With the
published window cutoff of 200 every window covers its whole episode
(max_len 16); with the cutoff cut to 6 windows start inside the episode
and end short of its terminal state. The encoder is on and off.

Compared: the params (the target actor too), Adam's moments and step,
the five replay fields the step writes over the windows, far_count and
the metrics. The two recursions are held alone against a copy of the
JAX package's lax.scan, nsteps = 1 and nsteps = S included; the port
runs them through K1's affine_suffix_scan (its plain loop here), whose
product b Q reassociates the arithmetic.

Tolerances: the recursion rtol 1e-5 / atol 1e-5; params rtol 1e-5 / atol
1e-7; Adam moments rtol 1e-3 (a gradient summed over 16-step windows and
7 advantage outputs in another order); replay fields and metrics rtol
1e-4 / atol 1e-5; far counts, steps and lengths exact. The act function
as in _torch_learner_cases.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos import acer as jacer
from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.core.mdp import MDPSpec as JMDP
from smarties_tpu.ops import continuous_policy as jcp
from smarties_tpu.replay import buffer as jrb
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos import acer as tacer
from smarties_tpu_torch.algos.registry import make_learner as tmake
from smarties_tpu_torch.core.mdp import MDPSpec as TMDP
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.ops.returns import affine_suffix_scan_plain
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, np32, tn, tt)

E, L, B, DIM_S = 16, 16, 8, 4
MDP_KW = dict(dim_state=DIM_S, dim_action=2, bounded=(True, False),
              upper_action=(2.0, 1.0), lower_action=(-2.0, -1.0))
BASE = dict(learner="ACER", nnLayerSizes=[16], batchSize=B,
            minTotObsNum=64, maxTotObsNum=400, clipImpWeight=5,
            explNoise=0.4472135955, gamma=0.995, targetDelay=1e-3,
            learnrate=1e-4, randSeed=0)
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-9)
FIELD_TOL = dict(rtol=1e-4, atol=1e-5)


def _learners(enc):
    d = dict(BASE, encoderLayerSizes=[16] if enc else [0])
    jl, tl = jmake(JMDP(**MDP_KW), JHP(**d)), tmake(TMDP(**MDP_KW), THP(**d))
    assert type(jl).__name__ == type(tl).__name__ == "ACER"
    assert tl.has_enc == jl.has_enc == enc
    return jl, tl


def _jax_replay(jmdp):
    """E slots of synthetic episodes (lengths 1..L, two of 1 and two of L,
    half terminal), committed and given their statistics by JAX."""
    rng = np.random.RandomState(0)
    V, L1 = E, L + 1
    lens = rng.randint(1, L + 1, V).astype(np.int32)
    lens[:4] = [1, 1, L, L]
    terminal = rng.rand(V) > 0.5
    rew = np.zeros((V, L1), np.float32)
    rho = np.zeros((V, L1), np.float32)
    for v, n in enumerate(lens):
        rew[v, 1:n + 1] = np32(rng.randn(n) + 1.0)
        rho[v, :n] = np.exp(rng.randn(n) * 0.5)
    nA = jmdp.dim_action
    mus = np.concatenate([np32(rng.randn(V, L1, nA) * 0.5),
                          np32(0.3 + np.abs(rng.randn(V, L1, nA)) * 0.2)],
                         -1)
    rs = jrb.init_replay(E, L, DIM_S, nA, jmdp.dim_policy, 5.0,
                         mu_init=jrb.safe_mu(jmdp))
    return jrb.commit_episodes(
        rs, jnp.asarray(np32(rng.randn(V, L1, DIM_S))),
        jnp.asarray(np32(rng.randn(V, L1, nA))), jnp.asarray(mus),
        jnp.asarray(rew), jnp.asarray(np32(rng.randn(V, L1))),
        jnp.zeros((V, L1)), jnp.zeros((V, L1)), jnp.asarray(rho),
        jnp.asarray(lens), jnp.asarray(terminal), jnp.ones(V, bool),
        BASE["maxTotObsNum"], "oldest")


def _pinned(rs, seed, n_steps):
    """B distinct episodes per step (the short and full ones among them)
    and raw window starts in [0, 2^30)."""
    rng = np.random.RandomState(seed)
    valid = np.nonzero(np.asarray(rs.ep_id) >= 0)[0]
    out = []
    for i in range(n_steps):
        ep = rng.choice(valid, B, replace=False)
        ep[:2] = valid[[i % 2, 2 + i % 2]]
        ep = np.unique(ep)
        while len(ep) < B:
            ep = np.unique(np.append(ep, rng.choice(valid)))
        out.append((ep.astype(np.int32),
                    rng.randint(0, 2 ** 30, B).astype(np.int32)))
    return out


def _jax_noise(key, S, nA):
    """The clipped normals JAX's train_step draws from `key`."""
    _, _, k_pol, k_ext = jax.random.split(key, 4)
    return (tt(jcp.clipped_normal(k_pol, (B, S + 1, nA))),
            tt(jcp.clipped_normal(k_ext, (jacer.N_EXPECTATION, B, S + 1,
                                          nA))))


@pytest.mark.parametrize("cutoff", [200, 6], ids=["cutoff200", "cutoff6"])
@pytest.mark.parametrize("enc", [True, False], ids=["enc", "no_enc"])
def test_four_train_steps(monkeypatch, enc, cutoff):
    monkeypatch.setattr(jacer, "SEQ_CUTOFF", cutoff)
    monkeypatch.setattr(tacer, "SEQ_CUTOFF", cutoff)
    jl, tl = _learners(enc)
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = jl.initialize_stats(_jax_replay(jl.mdp))
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    assert not any(x.requires_grad for x in tree_leaves(tp["tgt_actor"]))
    # the port's own initialize_stats touches the statistics only
    fresh = convert.replay_from_jax(jax_replay_views(_jax_replay(jl.mdp)))
    assert_replay_close(rs, tl.initialize_stats(fresh),
                        fields=("state_mean", "state_scale", "rew_scale",
                                "qret"), rtol=1e-5, atol=1e-6)
    S = min(cutoff, L)
    jp, jo, jr = params, opt, rs
    for i, (ep, tst) in enumerate(_pinned(rs, 2, 4)):
        key = jax.random.PRNGKey(10 + i)
        jp, jo, jr, jm = jl.train_step(
            jp, jo, jr, key, sample_override=(jnp.asarray(ep),
                                              jnp.asarray(tst)))
        tp, to, tr, tm = tl.train_step(
            tp, to, tr, sample_override=(tt(ep, torch.int32),
                                         tt(tst, torch.int32)),
            noise=_jax_noise(key, S, 2))
    jp, jm1, jm2 = (jax.device_get(x) for x in (jp, jo.m1, jo.m2))
    # the advantage net's output bias: its gradient is 0 analytically (the
    # taken action's cotangent cancels the 5 expectation samples'), so
    # both frameworks step it on ~1e-7 of rounding noise that Adam scales
    # to whole steps of the critics' 10 x learnrate; it is held apart
    b0 = float(params["net"]["advtg"]["out"]["b"][0])
    for got, m1 in ((tp["net"], to.m1), (jp["net"], jm1)):
        b, m = (np.asarray(tn(x) if isinstance(x, torch.Tensor) else x)
                for x in (got["advtg"]["out"]["b"], m1["advtg"]["out"]["b"]))
        assert abs(float(b[0]) - b0) <= 4 * 3 * 10 * BASE["learnrate"]
        assert abs(float(m[0])) < 1e-6
    for tree in (tp["net"], jp["net"], to.m1, to.m2, jm1, jm2):
        tree["advtg"]["out"] = {"W": tree["advtg"]["out"]["W"]}
    assert_tree_close(tp, jp, **PARAM_TOL)
    assert_tree_close(to.m1, jm1, **MOMENT_TOL)
    assert_tree_close(to.m2, jm2, **MOMENT_TOL)
    assert int(to.step) == int(jo.step) == 4
    np.testing.assert_allclose(float(to.beta_t_2), float(jo.beta_t_2),
                               rtol=1e-6)
    # the target actor moved off the initial actor (Polyak at 1e-3)
    moved = [np.abs(tn(a) - np.asarray(b)).max() for a, b in zip(
        tree_leaves(tp["tgt_actor"]),
        jax.tree_util.tree_leaves(params["tgt_actor"]))]
    assert max(moved) > 0
    assert_replay_close(jr, tr, fields=("rho", "kl", "delta", "value",
                                        "advantage", "beta", "alpha",
                                        "cmax_ret", "max_abs_error"),
                        **FIELD_TOL)
    assert_replay_close(jr, tr, fields=("far_count", "length", "ep_id",
                                        "qret"), rtol=0, atol=0)
    # the steps wrote TD errors and far counts moved
    assert np.abs(tn(tr.delta_tm)).max() > 0
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **FIELD_TOL)


def _jax_recursions(r, v, q_theta, c, nsteps, q_boot, gamma):
    """acer.py:248-267, the JAX package's two recursions, on [B, S+1]."""
    Bn, S = r.shape[0], r.shape[1] - 1
    active = jnp.arange(S + 1)[None, :] < nsteps[:, None]

    def recur(carry, i):
        q_ret, q_opc = carry
        s = S - 1 - i
        on = active[:, s]
        q_ret_s = jnp.where(s == nsteps - 1, q_boot, q_ret)
        q_opc_s = jnp.where(s == nsteps - 1, q_boot, q_opc)
        nq_ret = r[:, s] + gamma * (c[:, s] * (q_ret_s - q_theta[:, s])
                                    + v[:, s])
        nq_opc = r[:, s] + gamma * ((q_opc_s - q_theta[:, s]) + v[:, s])
        return ((jnp.where(on, nq_ret, q_ret), jnp.where(on, nq_opc, q_opc)),
                (q_ret_s, q_opc_s))

    _, (qr, qo) = jax.lax.scan(recur, (jnp.zeros(Bn), jnp.zeros(Bn)),
                               jnp.arange(S))
    return np.flip(np.asarray(qr).T, 1), np.flip(np.asarray(qo).T, 1)


@pytest.mark.parametrize("S", [1, 7, 200])
def test_recursions_on_the_scan(S):
    rng = np.random.RandomState(S)
    Bn = 12
    r, v, qt = (np32(rng.randn(Bn, S + 1)) for _ in range(3))
    c = np32(rng.rand(Bn, S + 1))
    nsteps = rng.randint(1, S + 1, Bn).astype(np.int32)
    nsteps[:2] = [1, S]
    q_boot = np32(rng.randn(Bn))
    want_ret, want_opc = _jax_recursions(*(jnp.asarray(x) for x in (
        r, v, qt, c, nsteps, q_boot)), 0.995)
    a1, b1 = tacer.window_coeffs(tt(r), tt(v), tt(qt), tt(c),
                                 tt(nsteps, torch.long), tt(q_boot), 0.995)
    a2, b2 = tacer.window_coeffs(tt(r), tt(v), tt(qt), torch.ones(Bn, S + 1),
                                 tt(nsteps, torch.long), tt(q_boot), 0.995)
    q = affine_suffix_scan_plain(torch.cat([a1, a2]), torch.cat([b1, b2]))
    np.testing.assert_allclose(tn(q[:Bn]), want_ret, **SCAN_TOL)
    np.testing.assert_allclose(tn(q[Bn:]), want_opc, **SCAN_TOL)
    # the boundary row holds q_boot; beyond the window the scan is 0
    np.testing.assert_allclose(tn(q[:Bn])[np.arange(Bn), nsteps - 1],
                               q_boot, rtol=0, atol=0)
    beyond = np.arange(S)[None, :] >= nsteps[:, None]
    assert (tn(q[:Bn])[beyond] == 0).all() and (tn(q[Bn:])[beyond] == 0).all()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("enc", [True, False], ids=["enc", "no_enc"])
def test_act(enc, train):
    jl, tl = _learners(enc)
    params, _ = jl.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.device_get(params))
    obs = np32(np.random.RandomState(3).randn(16, DIM_S))
    key = jax.random.PRNGKey(5)
    jout = jl.make_act_fn(train)(params, jnp.asarray(obs), key, ())
    noise = tt(jcp.clipped_normal(key, (16, 2))) if train else None
    tout = tl.make_act_fn(train)(tp, tt(obs), None, (), noise=noise)
    for what, got, want in zip(("action", "mu", "value", "advantage"),
                               tout[:4], jout[:4]):
        np.testing.assert_allclose(tn(got), np.asarray(want), err_msg=what,
                                   rtol=1e-4, atol=1e-5)
    assert tout[4] == ()


def test_discrete_refused():
    from smarties_tpu_torch.envs import cartpole
    with pytest.raises(ValueError, match="continuous"):
        tmake(cartpole.discrete.MDP, THP(**BASE))


def test_trainer_presample_and_checkpoint(tmp_path):
    """ACER in the Trainer on pendulum: the fused cycle draws through
    presample_fn, each step is one window step; a checkpoint restores the
    nested params, the target actor and the split Adam state exactly,
    and both trainers go on identically."""
    from smarties_tpu_torch.envs import pendulum
    from smarties_tpu_torch.runtime.trainer import Trainer, _plain

    cfg = THP(**dict(BASE, encoderLayerSizes=[16], minTotObsNum=128,
                     maxTotObsNum=512))

    def trainer():
        return Trainer(pendulum, pendulum.MDP, cfg, n_envs=8, n_slots=64,
                       max_len=32, device="cpu")

    tr = trainer()
    calls = []
    fn = tr.algo.presample_fn
    tr.algo.presample_fn = lambda *a: calls.append(a[2:]) or fn(*a)
    assert tr._can_presample
    tr.warmup(chunk=16)
    tr.train_fused(16, log_every=10 ** 9)
    assert tr.n_grad_steps == 16 and calls == [(B, 8), (B, 8)]
    assert all(torch.isfinite(x).all() for x in tree_leaves(tr.params))
    path = str(tmp_path / "ck.pt")
    tr.save(path)
    fresh = trainer()
    fresh.restore(path)
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(tr.params),
                    strict=True):
        assert torch.equal(a, b.detach())
    assert not any(x.requires_grad
                   for x in tree_leaves(fresh.params["tgt_actor"]))
    for a, b in zip(tree_leaves(_plain(fresh.opt_state)),
                    tree_leaves(_plain(tr.opt_state)), strict=True):
        assert torch.equal(a, b)
    for x in (tr, fresh):
        x.train_fused(8, log_every=10 ** 9)
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(tr.params),
                    strict=True):
        assert torch.equal(a, b)
    rets = fresh.evaluate(2, max_steps=20)
    assert np.isfinite(rets).all()

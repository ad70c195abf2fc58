"""Port parity: RACER-ES (smarties_tpu_torch/algos/racer_es.py) against
the JAX package's (smarties_tpu/algos/racer_es.py).

V-RACER (continuous), RACER with the Gaussian advantage and RACER
discrete, with a population of 6, on 24 slots of synthetic episodes. The
JAX package builds the learner, its population and ESOptState and a
replay with its statistics and returns; everything goes through
smarties_tpu_torch.models.convert into the port. Both take 4 train steps:
the JAX step draws its minibatch and the resample's normals from
split(key) inside the step, and the test draws the same from the same
keys and pins them in the port (sample_override, z). Compared: the
population, the ES state, the replay write-backs (member 0's), the
ReF-ER scalars and the metrics. The act function uses member 0, with the
JAX draw injected as in _torch_learner_cases.py. Last, the learner in the
Trainer: it does not presample, and its fused cycles draw in the step.

Tolerances: the population and ES state rtol 1e-5 / atol 1e-6 (the
member ranking of the two frameworks agrees; the update is elementwise
f32 arithmetic); rho, KL and advantage rtol 1e-4 / atol 1e-5; values,
TD errors and the avg_v / rmse metrics atol 2e-3 (scale_net2v cancels two
terms near 5100); other metrics rtol 1e-4 / atol 1e-6; counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.envs import cartpole as jc
from smarties_tpu.ops import continuous_policy as jcp
from smarties_tpu.replay import buffer as jrb
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos.registry import make_learner as tmake
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, np32, tn, tt)

E, L, B, P = 24, 20, 16, 6
BASE = dict(nnLayerSizes=[16, 16], batchSize=B, minTotObsNum=64,
            maxTotObsNum=400, ESpopSize=P, clipImpWeight=4,
            explNoise=0.447214, gamma=0.995, learnrate=0.001, epsAnneal=0,
            outWeightsPrefac=0.01, randSeed=0)
POP_TOL = dict(rtol=1e-5, atol=1e-6)
POLICY_TOL = dict(rtol=1e-4, atol=1e-5)
VALUE_TOL = dict(rtol=1e-4, atol=2e-3)
# name: (discrete MDP?, learner, advantage family)
CASES = {"vracer": (False, "VRACER", "zero"),
         "racer_gaussian": (False, "RACER", "gaussian"),
         "racer_discrete": (True, "RACER", "discrete")}


def _setup(name):
    discrete, learner, adv = CASES[name]
    jmdp, tmdp = ((jc.discrete.MDP, tc.discrete.MDP) if discrete
                  else (jc.MDP, tc.MDP))
    d = dict(BASE, learner=learner)
    jl, tl = jmake(jmdp, JHP(**d)), tmake(tmdp, THP(**d))
    assert type(jl).__name__ == type(tl).__name__ == "RacerES"
    assert tl.adv_kind == jl.adv_kind == adv and tl.presample is False
    return jl, tl


def _jax_replay(jmdp):
    """E slots of synthetic episodes (lengths 3..L, half terminal)."""
    rng = np.random.RandomState(0)
    V, L1 = E, L + 1
    lens = rng.randint(3, L + 1, V).astype(np.int32)
    rew = np.zeros((V, L1), np.float32)
    rho = np.zeros((V, L1), np.float32)
    for v, n in enumerate(lens):
        rew[v, 1:n + 1] = np32(rng.randn(n) + 1.0)
        rho[v, :n] = 1.0
    if jmdp.is_discrete:
        acts = np32(rng.randint(0, 2, (V, L1, 1)))
        p = np32(0.2 + rng.rand(V, L1, 2))
        mus = p / p.sum(-1, keepdims=True)
    else:
        acts = np32(rng.randn(V, L1, 1))
        mus = np.concatenate([np32(rng.randn(V, L1, 1) * 0.5),
                              np32(0.3 + np.abs(rng.randn(V, L1, 1)) * 0.2)],
                             -1)
    rs = jrb.init_replay(E, L, 5, 1, jmdp.dim_policy, 4.0,
                         mu_init=jrb.safe_mu(jmdp))
    return jrb.commit_episodes(
        rs, jnp.asarray(np32(rng.randn(V, L1, 5) * 0.5)), jnp.asarray(acts),
        jnp.asarray(mus), jnp.asarray(rew),
        jnp.asarray(np32(rng.randn(V, L1))), jnp.zeros((V, L1)),
        jnp.zeros((V, L1)), jnp.asarray(rho), jnp.asarray(lens),
        jnp.asarray(rng.rand(V) > 0.5), jnp.ones(V, bool),
        BASE["maxTotObsNum"], "oldest")


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_train_steps(name):
    jl, tl = _setup(name)
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = jl.initialize_stats(_jax_replay(jl.mdp))
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    assert type(to).__name__ == "ESOptState"
    assert not tp["pop"].requires_grad
    tr = convert.replay_from_jax(jax_replay_views(rs))
    n = params["pop"].shape[1]
    assert tl.unravel.n == n
    jp, jo, jr = params, opt, rs
    for i in range(4):
        key = jax.random.PRNGKey(20 + i)
        k_samp, k_res = jax.random.split(key)
        ep, t = jrb.sample(k_samp, jr, B, jl.cfg.dataSamplingAlgo)
        z = jax.random.normal(k_res, (P, n), jnp.float32)
        jp, jo, jr, jm = jl.train_step(jp, jo, jr, key)
        tp, to, tr, tm = tl.train_step(
            tp, to, tr, sample_override=(tt(ep, torch.int32),
                                         tt(t, torch.int32)), z=tt(z))
    assert_tree_close(tp, jax.device_get(jp), **POP_TOL)
    for f in ("diag_cov", "path_cov", "noise"):
        np.testing.assert_allclose(tn(getattr(to, f)),
                                   np.asarray(getattr(jo, f)), err_msg=f,
                                   **POP_TOL)
    assert int(to.step) == int(jo.step) == 4
    # the population moved off its first mean
    assert np.abs(tn(tp["pop"][0]) - np.asarray(params["pop"][0])).max() > 0
    assert_replay_close(jr, tr, fields=("rho", "kl", "advantage"),
                        **POLICY_TOL)
    assert_replay_close(jr, tr, fields=("delta", "value", "max_abs_error"),
                        **VALUE_TOL)
    assert_replay_close(jr, tr, fields=("far_count", "length", "ep_id"),
                        rtol=0, atol=0)
    assert_replay_close(jr, tr, fields=("beta", "alpha", "cmax_ret"),
                        rtol=1e-5, atol=1e-7)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        tol = VALUE_TOL if k in ("avg_v", "rmse") else dict(rtol=1e-4,
                                                             atol=1e-6)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_act(name, train):
    jl, tl = _setup(name)
    params, _ = jl.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.device_get(params))
    obs = np32(np.random.RandomState(3).randn(16, 5))
    key = jax.random.PRNGKey(5)
    jout = jl.make_act_fn(train)(params, jnp.asarray(obs), key, ())
    noise = None
    if train and not jl.mdp.is_discrete:
        noise = tt(jcp.clipped_normal(key, (16, 1)))
    elif train:
        # a uniform inside the option JAX chose
        o = np.asarray(jout[0])[:, 0].astype(int)
        mu = np.asarray(jout[1])
        c = np.cumsum(mu, -1)
        lo = np.where(o > 0, c[np.arange(16), np.maximum(o - 1, 0)], 0.0)
        noise = tt((lo + c[np.arange(16), o]) / 2 / c[:, -1])
    tout = tl.make_act_fn(train)(tp, tt(obs), None, (), noise=noise)
    for what, got, want, tol in zip(
            ("action", "mu", "value", "advantage"), tout[:4], jout[:4],
            (POLICY_TOL, POLICY_TOL, VALUE_TOL, VALUE_TOL)):
        np.testing.assert_allclose(tn(got), np.asarray(want), err_msg=what,
                                   **tol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_cycle(name, monkeypatch):
    """The Trainer keeps the fused cycle (each step draws its own
    minibatch), keeps the obsPerStep invariant and sweeps returns (K1's
    plain version here) as V-RACER does: once per cycle at ingest."""
    from smarties_tpu_torch.ops import retrace_kernel as rk
    from smarties_tpu_torch.runtime.trainer import Trainer
    discrete, learner, _ = CASES[name]
    env = tc.discrete if discrete else tc
    cfg = THP(**dict(BASE, learner=learner, minTotObsNum=256,
                     maxTotObsNum=1024))
    tr = Trainer(env, env.MDP, cfg, n_envs=8, n_slots=64, max_len=64,
                 device="cpu")
    assert not tr._can_presample
    tr.warmup(chunk=16)
    assert (tn(tr.replay.qret_tm) != 0).any()
    sweeps = []
    sweep = rk.retrace_sweep_
    monkeypatch.setattr(rk, "retrace_sweep_",
                        lambda *a: sweeps.append(a[13]) or sweep(*a))
    chunks = []
    fused = tr._fused_cycle
    tr._fused_cycle = lambda *a: chunks.append(a) or fused(*a)
    g0, pop0 = tr.n_grad_steps, tn(tr.params["pop"]).copy()
    tr.train_fused(24, log_every=10 ** 9)
    assert chunks == [(1, 8)] * 3 and tr.n_grad_steps == g0 + 24
    n_loc = tr.n_env_steps - tr.n_obs_b4_start
    assert abs(n_loc - tr.n_grad_steps) <= tr.n_envs + n_loc - 24
    assert int(tr.opt_state.step) == 24
    assert np.abs(tn(tr.params["pop"]) - pop0).max() > 0
    assert sweeps == ["retrace"] * 3
    assert all(torch.isfinite(v).all() for v in tr._last_metrics.values())
    assert np.isfinite(tr.evaluate(2, max_steps=30)).all()

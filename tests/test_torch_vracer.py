"""Port parity: V-RACER gradient steps.

A replay of synthetic cart-pole-shaped episodes is built and initialised
by the JAX package (initialize_stats), then converted with
smarties_tpu_torch.models.convert together with the JAX-initialised
params and Adam state. Both frameworks then take the same train steps on
pinned (ep, t) samples (sample_override) — distinct pairs, including
steps just before a truncation so the V(s_T) refresh runs.

Tolerances: the forward/backward matmuls reduce in another order, so
network outputs agree to ~1e-6 relative. V = scale_net2v(v_raw) then
subtracts two terms near 5100, where one f32 ulp is 4.9e-4: V, the TD
error and V(s_T) agree to atol 2e-3 (as in test_torch_ops), and the
value-head gradient inherits that, so the Adam moments get rtol 1e-3.
Parameters move by eta_t * (m / sqrt(v)) ~ 3e-5 per step: atol 1e-7 on
them is ~0.3% of one step. rho and KL (rtol 1e-4, atol 1e-5) depend on
the policy outputs only; far counts are exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos.vracer import VRacer as JVRacer
from smarties_tpu.envs import cartpole as jc
from smarties_tpu.replay import buffer as jrb
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos.vracer import VRacer as TVRacer
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, np32, tn, tt)

E, L, B = 24, 20, 32
CFG = dict(nnLayerSizes=[16, 16], batchSize=B, minTotObsNum=64,
           maxTotObsNum=400, randSeed=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-9)
POLICY_TOL = dict(rtol=1e-4, atol=1e-5)
VALUE_TOL = dict(rtol=1e-4, atol=2e-3)


def _jax_setup():
    mdp = jc.MDP
    jl = JVRacer(mdp, JHP(**CFG))
    params, opt = jl.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    V, L1 = E, L + 1
    lens = rng.randint(3, L + 1, V).astype(np.int32)
    lens[:4] = L                               # full-length slots
    terminal = rng.rand(V) > 0.5
    rew = np.zeros((V, L1), np.float32)
    rho = np.zeros((V, L1), np.float32)
    for v, n in enumerate(lens):
        rew[v, 1:n + 1] = 1.0 - (terminal[v] & (np.arange(n) == n - 1))
        rho[v, :n] = 1.0
    mus = np.concatenate([np32(rng.randn(V, L1, 1) * 0.5),
                          np32(0.3 + np.abs(rng.randn(V, L1, 1)) * 0.2)], -1)
    rs = jrb.init_replay(E, L, 5, 1, 2, 4.0, mu_init=jrb.safe_mu(mdp))
    rs = jrb.commit_episodes(
        rs, jnp.asarray(np32(rng.randn(V, L1, 5) * 0.1)),
        jnp.asarray(np32(rng.randn(V, L1, 1))), jnp.asarray(mus),
        jnp.asarray(rew), jnp.asarray(np32(rng.randn(V, L1))),
        jnp.zeros((V, L1)), jnp.zeros((V, L1)), jnp.asarray(rho),
        jnp.asarray(lens), jnp.asarray(terminal), jnp.ones(V, bool),
        CFG["maxTotObsNum"], "oldest")
    return jl, params, opt, rs


def _pinned(rs, seed, n_steps):
    """Distinct (ep, t) pairs per step; half the batch at t = T-1."""
    rng = np.random.RandomState(seed)
    lens = np.asarray(rs.length)
    valid = np.nonzero(np.asarray(rs.ep_id) >= 0)[0]
    out = []
    for _ in range(n_steps):
        pairs = {(int(e), int(lens[e]) - 1)
                 for e in rng.choice(valid, B // 2, replace=False)}
        while len(pairs) < B:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, lens[e]))))
        ep, t = (np.asarray(x, np.int32) for x in zip(*sorted(pairs)))
        out.append((ep, t))
    return out


@pytest.fixture(scope="module")
def committed():
    return _jax_setup()


@pytest.fixture(scope="module")
def setup(committed):
    jl, params, opt, rs = committed
    return jl, params, opt, jl.initialize_stats(rs)


def test_converted_forward_matches(setup):
    jl, params, _, rs = setup
    tl = TVRacer(tc.MDP, THP(**CFG))
    assert tl.spec.total_out == jl.spec.total_out == 3
    x = np32(np.random.RandomState(1).randn(16, 5))
    from smarties_tpu.models.net import apply_net as japply
    from smarties_tpu_torch.models.net import apply_net as tapply
    want, _ = japply(params, jl.spec, jnp.asarray(x))
    got, _ = tapply(convert.params_from_jax(jax.device_get(params)),
                    tl.spec, tt(x))
    np.testing.assert_allclose(tn(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_train_steps(setup, n_steps):
    """params, Adam moments, write-backs (rho, kl, delta, value), beta,
    far_count, v_trunc and the metrics after n pinned steps."""
    jl, params, opt, rs = setup
    tl = TVRacer(tc.MDP, THP(**CFG))
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.adam_state_from_jax(jax.device_get(opt))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    jp, jo, jr = params, opt, rs
    for ep, t in _pinned(rs, 2, n_steps):
        jp, jo, jr, jm = jl.train_step(
            jp, jo, jr, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(ep), jnp.asarray(t)))
        tp, to, tr, tm = tl.train_step(
            tp, to, tr, sample_override=(tt(ep, torch.int32),
                                         tt(t, torch.int32)))
    assert_tree_close(tp, jax.device_get(jp), **PARAM_TOL)
    assert_tree_close(to.m1, jax.device_get(jo.m1), **MOMENT_TOL)
    assert_tree_close(to.m2, jax.device_get(jo.m2), **MOMENT_TOL)
    assert int(to.step) == int(jo.step) == n_steps
    assert_replay_close(jr, tr, fields=("rho", "kl", "advantage"),
                        **POLICY_TOL)
    assert_replay_close(jr, tr, fields=("delta", "value", "v_trunc"),
                        **VALUE_TOL)
    assert_replay_close(jr, tr, fields=("far_count", "length", "ep_id"),
                        rtol=0, atol=0)
    assert_replay_close(jr, tr, fields=("beta", "alpha", "cmax_ret",
                                        "max_abs_error"), rtol=1e-5,
                        atol=1e-7)
    # V(s_T) was refreshed for the truncated slots that were sampled
    assert (tn(tr.v_trunc) != np.asarray(rs.v_trunc)).any()
    for k in ("avg_dkl", "avg_rho", "rmse", "avg_v", "grad_norm",
              "grad_max", "frac_far_batch", "beta"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


SWEEP_FIELDS = ("qret", "far_count", "rew_mean", "rew_std", "rew_scale",
                "state_mean", "state_std", "state_scale")


def test_initialize_stats(committed):
    """Exact stats from the stored data, then every return estimate."""
    jl, _, _, rs = committed
    tr = TVRacer(tc.MDP, THP(**CFG)).initialize_stats(
        convert.replay_from_jax(jax_replay_views(rs)))
    assert_replay_close(jl.initialize_stats(rs), tr, fields=SWEEP_FIELDS,
                        rtol=1e-4, atol=1e-4)


def test_refresh(setup):
    """refresh(): returns with the old scaling, then the stats update."""
    jl, _, _, rs = setup
    tl = TVRacer(tc.MDP, THP(**CFG))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    jr = jl.refresh(rs, 3000.0)
    tr = tl.refresh(tr, 3000.0)
    assert_replay_close(jr, tr, fields=SWEEP_FIELDS, rtol=1e-4, atol=1e-4)

"""Port parity: CMA-ES (smarties_tpu_torch/algos/cma.py) against the JAX
package's (smarties_tpu/algos/cma.py).

- `pop_weights` and the population constants.
- The flat weight vector: the port's `ravel` of a converted param tree is
  jax.flatten_util.ravel_pytree's vector (dense layers with a param head,
  RNN and LSTM layers: sorted keys, "R" < "W" < "b"), and `Unravel` gives
  the leaves back, for a [P, n] matrix as views.
- `_sample_pop` and `_cma_update` from a carried CMAState with the JAX
  normals injected, on pinned losses with ties (members whose episodes
  all reach max_len).
- One `_generation_rollout` on pendulum from a carried env state, with
  the JAX lanes' acting noise injected: pendulum episodes end only at
  max_len, and with n_steps == max_len no reset's draw enters what is
  compared (the per-member returns and counts, the observation moments).
- `evaluate` of the mean from the same start states.
- The twin of tests/test_all_algos.py::test_cma.

Tolerances: the weights, the sample and the update rtol 1e-6 / atol 1e-7
(elementwise f32 arithmetic and [P]-long sums); the rollout's returns and
moments rtol 1e-5 / atol 1e-4 (16 steps of a batched product against
per-lane products); the eval returns rtol 1e-5; counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from smarties_tpu.algos import cma as jcma
from smarties_tpu.envs import cartpole as jcart
from smarties_tpu.envs import pendulum as jpend
from smarties_tpu.models.net import NetSpec as JSpec
from smarties_tpu.models.net import init_params as jinit
from smarties_tpu.ops import continuous_policy as jcp
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos import cma as tcma
from smarties_tpu_torch.envs import cartpole as tcart
from smarties_tpu_torch.envs import pendulum as tpend
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import assert_tree_close, np32, tn, tt

TOL = dict(rtol=1e-6, atol=1e-7)
ROLL_TOL = dict(rtol=1e-5, atol=1e-4)
CFG = dict(learner="CMA", ESpopSize=4, batchSize=2, explNoise=0.1,
           nnLayerSizes=[16], learnrate=0.02, randSeed=0)


def _pair(jenv, tenv, n_envs=8, max_len=64, **extra):
    d = dict(CFG, **extra)
    return (jcma.CMAES(jenv, jenv.MDP, JHP(**d), n_envs=n_envs,
                       max_len=max_len),
            tcma.CMAES(tenv, tenv.MDP, THP(**d), n_envs=n_envs,
                       max_len=max_len, device="cpu"))


def _carry(jst):
    """A JAX CMAState -> the port's, through models/convert."""
    st = convert.opt_state_from_jax(jax.device_get(jst))
    assert type(st).__name__ == "CMAState"
    return st


@pytest.mark.parametrize("P", [2, 4, 12, 60])
def test_pop_weights(P):
    np.testing.assert_array_equal(tcma.pop_weights(P), jcma.pop_weights(P))
    jc, tc = _pair(jpend, tpend, n_envs=P, ESpopSize=P)
    assert tc.mu_eff == pytest.approx(jc.mu_eff, rel=1e-6)
    assert tc.sum_w == pytest.approx(jc.sum_w, rel=1e-6)


@pytest.mark.parametrize("kind,n_param", [("FFNN", 2), ("RNN", 0),
                                          ("LSTM", 1)])
def test_flat_order(kind, n_param):
    spec = JSpec(n_in=5, hidden=(6, 4), n_out=3, kind=kind,
                 n_param_out=n_param)
    params = jinit(jax.random.PRNGKey(1), spec)
    flat, unravel = ravel_pytree(params)
    tp = convert.params_from_jax(jax.device_get(params))
    got = tcma.ravel(tp)
    np.testing.assert_array_equal(tn(got), np.asarray(flat))
    un = tcma.Unravel(tp)
    assert un.n == flat.shape[0]
    assert_tree_close(un(got), jax.device_get(unravel(flat)), rtol=0,
                      atol=0)
    # a population matrix: leaves with a leading member axis, as views
    pop = torch.stack([got, 2 * got, -got])
    tree = un(pop)
    for leaf, one in zip(tree_leaves(tree), tree_leaves(un(got))):
        assert leaf.shape == (3,) + one.shape
        assert leaf.untyped_storage().data_ptr() == \
            pop.untyped_storage().data_ptr()
        np.testing.assert_array_equal(tn(leaf[1]), 2 * tn(one))


def test_sample_and_update():
    jc, tc = _pair(jcart, tcart)
    jst = jc.init(jax.random.PRNGKey(3))
    st = _carry(jst)
    np.testing.assert_array_equal(tn(st.pop), np.asarray(jst.pop))
    # the layout: the port's init gives a vector of the same length
    assert tc.unravel.n == jst.mean.shape[0] == tcma.ravel(
        tc.unravel(st.mean)).shape[0]
    rng = np.random.RandomState(0)
    n = jst.mean.shape[0]
    jst = jst._replace(diag_cov=jnp.asarray(np32(0.5 + rng.rand(n))),
                       path_cov=jnp.asarray(np32(rng.randn(n) * 0.1)),
                       gen=jnp.int32(3))
    st = _carry(jst)
    key = jax.random.PRNGKey(7)
    z = jax.random.normal(key, (tc.P, n), jnp.float32)
    want = jc._sample_pop(jst, key)
    got = tc._sample_pop(st, z=tt(z))
    for f in ("pop", "noise"):
        np.testing.assert_allclose(tn(getattr(got, f)),
                                   np.asarray(getattr(want, f)), **TOL)
    # member 0 is the mean; the even members mirror the odd ones
    np.testing.assert_array_equal(tn(got.noise[0]), 0)
    np.testing.assert_array_equal(tn(got.noise[2]), -tn(got.noise[1]))
    # losses with ties, then the update and the resample
    for losses in ([-3.0, -1.0, -3.0, -2.0], [-5.0, -5.0, -5.0, -5.0]):
        key = jax.random.PRNGKey(11)
        z = jax.random.normal(key, (tc.P, n), jnp.float32)
        w = jc._cma_update(want, jnp.asarray(np32(losses)), key)
        g = tc._cma_update(got, tt(np32(losses)), z=tt(z))
        for f in ("mean", "diag_cov", "path_cov", "pop", "noise"):
            np.testing.assert_allclose(tn(getattr(g, f)),
                                       np.asarray(getattr(w, f)), **TOL,
                                       err_msg=f)
        assert int(g.gen) == int(w.gen) == 4


def test_generation_rollout_pendulum():
    L = 16
    jc, tc = _pair(jpend, tpend, n_envs=8, max_len=L)
    jst = jc.init(jax.random.PRNGKey(3))
    rng = np.random.RandomState(1)
    jst = jst._replace(state_mean=jnp.asarray(np32(rng.randn(3) * 0.1)),
                       state_scale=jnp.asarray(np32(1 + rng.rand(3))))
    es = jpend.init(jax.random.PRNGKey(4), 8)
    es = es._replace(step=jnp.full((8,), 150, jnp.int32))
    key = jax.random.PRNGKey(5)
    # the acting noise of JAX's scan: per step split(key, 3), per lane
    # split(k_act, V), one clipped normal of shape (nA,) per lane
    noise, k = [], key
    for _ in range(L):
        k, k_act, _ = jax.random.split(k, 3)
        noise.append(jax.vmap(lambda kk: jcp.clipped_normal(kk, (1,)))(
            jax.random.split(k_act, 8)))
    _, rsum, rcnt, _, (s1, s2, sc) = jc._generation_rollout(jst, es, key, L)
    tes = tpend.PendulumState(th=tt(es.th), thdot=tt(es.thdot),
                              step=tt(es.step, torch.int32))
    _, trs, trc, (t1, t2, tsc) = tc._generation_rollout(
        _carry(jst), tes, L, noise=tt(np.stack(noise)))
    np.testing.assert_array_equal(tn(trc), np.asarray(rcnt))
    assert int(trc.sum()) == 8 and tsc == int(sc)
    for got, want in ((trs, rsum), (t1, s1), (t2, s2)):
        np.testing.assert_allclose(tn(got), np.asarray(want), **ROLL_TOL)


def test_evaluate_mean():
    jc, tc = _pair(jcart, tcart)
    jc.state = jc.init(jax.random.PRNGKey(3))
    jc.state = jc.state._replace(mean=jc.state.pop[1])
    tc.state = _carry(jc.state)
    es = jcart.init(jax.random.PRNGKey(123), 6)
    want = jc.evaluate(6, key=jax.random.PRNGKey(123), max_steps=100)
    got = tc.evaluate(6, max_steps=100, start=tcart.CartPoleState(
        u=tt(es.u), step=tt(es.step, torch.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got >= 1).all()


def test_cma():
    """tests/test_all_algos.py::test_cma on the port."""
    cma = tcma.CMAES(tcart, tcart.MDP, THP(**CFG), n_envs=8, max_len=64,
                     device="cpu")
    cma.train(2, log_every=10)
    assert bool(torch.isfinite(cma.state.mean).all())
    assert cma.n_generations == 2 and len(cma.history) == 2
    assert int(cma.state.gen) == 2
    assert np.isfinite(cma.evaluate(2, max_steps=50)).all()


def test_lanes_must_divide():
    with pytest.raises(ValueError, match="divisible"):
        tcma.CMAES(tcart, tcart.MDP, THP(**CFG), n_envs=6, device="cpu")

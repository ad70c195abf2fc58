"""Port parity: the advantage families and their per-sample gradients.

smarties_tpu_torch.ops.advantages against smarties_tpu.ops.advantages on
inputs made from a seed: the discrete, Gaussian (both stop_policy_grad
modes) and quadratic advantages, and their per-sample gradients —
jax.vmap(jax.grad(...)) in the JAX learners, one torch.autograd.grad of
the batch sum (advantages.per_sample_grad) in the port. Small f32
reductions and products: values rtol 1e-5 / atol 1e-6, gradients rtol
1e-4 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smarties_tpu.ops import advantages as jadv
from smarties_tpu.ops import discrete_policy as jdp
from smarties_tpu_torch.ops import advantages as tadv

from _torch_parity import np32, tn, tt

B = 48
VAL_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _close(got, want, tol):
    np.testing.assert_allclose(tn(got), np.asarray(want), **tol)


def _per_sample_jax(fn, inputs, argnums):
    return jax.vmap(jax.grad(lambda *a: fn(*(x[None] for x in a))[0],
                             argnums=argnums))(*map(jnp.asarray, inputs))


def test_discrete_advantage():
    rng = np.random.RandomState(0)
    n = 4
    adv_out = np32(rng.randn(B, n))
    opt = rng.randint(0, n, B).astype(np.int32)
    _, _, probs = jdp.probs_of(jnp.asarray(np32(rng.randn(B, n))))
    probs = np.asarray(probs)
    want = jadv.discrete_advantage(jnp.asarray(adv_out), jnp.asarray(opt),
                                   jnp.asarray(probs))
    _close(tadv.discrete_advantage(tt(adv_out), tt(opt), tt(probs)), want,
           VAL_TOL)
    jg = _per_sample_jax(jadv.discrete_advantage, (adv_out, opt, probs), 0)
    tg, = tadv.per_sample_grad(tadv.discrete_advantage,
                               (tt(adv_out), tt(opt), tt(probs)))
    _close(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("n_act", [1, 3])
@pytest.mark.parametrize("stop_policy_grad", [True, False])
def test_gaussian_advantage(n_act, stop_policy_grad):
    rng = np.random.RandomState(n_act)
    adv_out = np32(rng.randn(B, 1 + 2 * n_act))
    action = np32(rng.randn(B, n_act))
    mean = np32(rng.randn(B, n_act))
    var = np32(0.1 + rng.rand(B, n_act))
    inputs = (adv_out, action, mean, var)

    def jfn(*a):
        return jadv.gaussian_advantage(*a, stop_policy_grad=stop_policy_grad)

    def tfn(*a):
        return tadv.gaussian_advantage(*a, stop_policy_grad=stop_policy_grad)

    _close(tfn(*map(tt, inputs)), jfn(*map(jnp.asarray, inputs)), VAL_TOL)
    wrt = (0,) if stop_policy_grad else (0, 2)
    jg = _per_sample_jax(jfn, inputs, wrt)
    tg = tadv.per_sample_grad(tfn, tuple(map(tt, inputs)), wrt=wrt)
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL)


@pytest.mark.parametrize("n_act", [1, 2, 3])
def test_quadratic_advantage(n_act):
    rng = np.random.RandomState(10 + n_act)
    nL = jadv.quadratic_n_outputs(n_act)
    assert tadv.quadratic_n_outputs(n_act) == nL
    l_out = np32(rng.randn(B, nL))
    mean = np32(rng.randn(B, n_act))
    action = np32(rng.randn(B, n_act))
    _close(tadv._build_L(tt(l_out), n_act),
           jadv._build_L(jnp.asarray(l_out), n_act), VAL_TOL)

    def jfn(lo, m, a):
        return jadv.quadratic_advantage(lo, m, a, n_act)

    def tfn(lo, m, a):
        return tadv.quadratic_advantage(lo, m, a, n_act)

    inputs = (l_out, mean, action)
    _close(tfn(*map(tt, inputs)), jfn(*map(jnp.asarray, inputs)), VAL_TOL)
    jg = _per_sample_jax(jfn, inputs, (0, 1))
    tg = tadv.per_sample_grad(tfn, tuple(map(tt, inputs)), wrt=(0, 1))
    for got, want in zip(tg, jg):
        _close(got, want, GRAD_TOL)
    # the policy-centred form (Quadratic_advantage.h, policy != nullptr)
    pol_mean = np32(rng.randn(B, n_act))
    pol_var = np32(0.1 + rng.rand(B, n_act))
    want = jadv.quadratic_advantage(*map(jnp.asarray, inputs), n_act,
                                    pol_mean=jnp.asarray(pol_mean),
                                    pol_var=jnp.asarray(pol_var))
    got = tadv.quadratic_advantage(*map(tt, inputs), n_act,
                                   pol_mean=tt(pol_mean),
                                   pol_var=tt(pol_var))
    _close(got, want, VAL_TOL)


def test_initial_bias_and_sizes():
    for n in (1, 2, 5):
        assert tadv.gaussian_n_outputs(n) == jadv.gaussian_n_outputs(n)
        assert tadv.gaussian_initial_bias(n) == \
            jadv.gaussian_initial_bias(n)
        assert tadv.discrete_n_outputs(n) == jadv.discrete_n_outputs(n)

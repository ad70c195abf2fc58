"""Port parity: the categorical policy, the label codec and discrete safe mu.

smarties_tpu_torch.ops.discrete_policy against smarties_tpu.ops.
discrete_policy on the same outputs and behaviour policies made from a
seed, for both normalizations (cheap SoftPlus and exp). The functions are
elementwise and row reductions over a few options: rtol 1e-5 / atol
1e-6 for the probabilities, rho, log-probabilities and KL, rtol 1e-4 /
atol 1e-6 for the analytic gradients (as tests/test_policies.py holds
them against autodiff). The draw: JAX's categorical cannot be reproduced,
so the port's inverse-CDF draw is held against a numpy inverse CDF on
pinned uniforms, and its generator draw against the probabilities
(2e5 draws, every option within 5 sigma of its expected count).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.core.mdp import MDPSpec as JMDP
from smarties_tpu.ops import discrete_policy as jdp
from smarties_tpu.replay import buffer as jrb
from smarties_tpu_torch.core.mdp import MDPSpec as TMDP
from smarties_tpu_torch.ops import discrete_policy as tdp
from smarties_tpu_torch.replay import buffer as trb

from _torch_parity import np32, tn, tt

B, NO = 64, 5
FNS = ("softplus", "exp")


def _inputs(seed):
    rng = np.random.RandomState(seed)
    out = np32(rng.randn(B, NO) * 2)
    _, _, mu = jdp.probs_of(jnp.asarray(np32(rng.randn(B, NO))))
    opt = rng.randint(0, NO, B).astype(np.int32)
    coef = np32(rng.randn(B))
    return out, np.asarray(mu), opt, coef


@pytest.mark.parametrize("fn", FNS)
def test_functions_match_jax(fn):
    out, mu, opt, coef = _inputs(0)
    jun, jnorm, jp = jdp.probs_of(jnp.asarray(out), fn=fn)
    tun, tnorm, tp = tdp.probs_of(tt(out), fn=fn)
    for got, want in ((tun, jun), (tnorm, jnorm), (tp, jp)):
        np.testing.assert_allclose(tn(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    jo, to = jnp.asarray(opt), tt(opt, torch.int32)
    jm, tm = jnp.asarray(mu), tt(mu)
    pairs = [
        (tdp.imp_weight(to, tp, tm), jdp.imp_weight(jo, jp, jm)),
        (tdp.logprob(to, tp), jdp.logprob(jo, jp)),
        (tdp.kl_mu_pi(tm, tp), jdp.kl_mu_pi(jm, jp)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(tn(got), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    g_pairs = [
        (tdp.pol_grad(to, tt(out), tun, tnorm, tp, tt(coef), fn=fn),
         jdp.pol_grad(jo, jnp.asarray(out), jun, jnorm, jp,
                      jnp.asarray(coef), fn=fn)),
        (tdp.kl_grad(tm, tt(out), tun, tnorm, tp, tt(coef), fn=fn),
         jdp.kl_grad(jm, jnp.asarray(out), jun, jnorm, jp,
                     jnp.asarray(coef), fn=fn)),
    ]
    for got, want in g_pairs:
        np.testing.assert_allclose(tn(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-6)
    np.testing.assert_array_equal(
        tn(tdp.select(None, tp, train=False)),
        np.asarray(jdp.select(jax.random.PRNGKey(0), jp, False)))


@pytest.mark.parametrize("fn", FNS)
def test_analytic_grads_match_autograd(fn):
    """pol_grad and kl_grad are d(coef log pi)/do and d(coef KL)/do."""
    out, mu, opt, coef = _inputs(1)
    c = tt(coef)

    def grad_of(objective):
        o = tt(out).requires_grad_(True)
        return torch.autograd.grad(objective(tdp.probs_of(o, fn=fn)[2]),
                                   o)[0]

    lp_grad = grad_of(lambda p: torch.sum(
        c * tdp.logprob(tt(opt, torch.int32), p)))
    kl_grad = grad_of(lambda p: torch.sum(c * tdp.kl_mu_pi(tt(mu), p)))
    with torch.no_grad():
        un, norm, p = tdp.probs_of(tt(out), fn=fn)
        g_pol = tdp.pol_grad(tt(opt, torch.int32), tt(out), un, norm, p, c,
                             fn=fn)
        g_kl = tdp.kl_grad(tt(mu), tt(out), un, norm, p, c, fn=fn)
    np.testing.assert_allclose(tn(g_pol), tn(lp_grad), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tn(g_kl), tn(kl_grad), rtol=1e-4, atol=1e-6)


def test_sample_with_uniform_is_inverse_cdf():
    rng = np.random.RandomState(2)
    probs = np32(rng.rand(B, NO))
    probs[:, 1] = 0.0                      # a zero-probability option
    probs[3] = [0, 0, 1, 0, 0]             # a one-hot row
    u = np32(rng.rand(B))
    u[:4] = [0.0, 0.999999, 0.5, 0.25]
    c = np.cumsum(probs, axis=-1)
    want = np.array([min(np.searchsorted(c[i], u[i] * c[i, -1],
                                         side="right"), NO - 1)
                     for i in range(B)])
    got = tn(tdp.sample_with_uniform(tt(u), tt(probs)))
    np.testing.assert_array_equal(got, want)
    assert not (got == 1).any() and got[3] == 2


def test_generator_draw_frequencies():
    n = 200_000
    p = np.array([0.05, 0.3, 0.0, 0.15, 0.5])
    probs = tt(np.broadcast_to(np32(p), (n, NO)))
    draws = tn(tdp.sample(torch.Generator().manual_seed(0), probs))
    counts = np.bincount(draws, minlength=NO)
    sigma = np.sqrt(n * p * (1 - p))
    assert counts[2] == 0
    assert (np.abs(counts - n * p) <= 5 * sigma + 1e-9).all(), counts


def test_label_codec_and_safe_mu():
    kw = dict(dim_state=3, dim_action=2, discrete_values=(3, 4))
    jm, tm = JMDP(**kw), TMDP(**kw)
    assert tm.discrete_shifts == jm.discrete_shifts == (1, 3)
    labels = np.arange(12, dtype=np.int32)
    jcomp = np.asarray(jm.label_to_components(jnp.asarray(labels)))
    tcomp = tm.label_to_components(tt(labels, torch.int32))
    np.testing.assert_array_equal(tn(tcomp), jcomp)
    np.testing.assert_array_equal(tn(tm.components_to_label(tcomp)), labels)
    np.testing.assert_array_equal(trb.safe_mu(tm), jrb.safe_mu(jm))

"""Port parity: elementwise ops, the continuous policy and the MDP codec.

Each op of smarties_tpu_torch.ops / core.mdp against its JAX twin on the
same seeded numpy inputs. Elementwise ops compute the same f32 formula in
both frameworks: rtol 1e-6 (a few ulps for transcendental functions).
Ops that reduce over the action dims, or take exp/log of a difference,
get rtol 1e-5 and a small atol for values near zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.core.mdp import MDPSpec as JMDP
from smarties_tpu.ops import continuous_policy as jcp
from smarties_tpu.ops import softplus as jsp
from smarties_tpu.ops import value_scale as jvs
from smarties_tpu_torch.core.mdp import MDPSpec as TMDP
from smarties_tpu_torch.ops import continuous_policy as tcp
from smarties_tpu_torch.ops import softplus as tsp
from smarties_tpu_torch.ops import value_scale as tvs

from _torch_parity import np32, tn, tt

ELEMENTWISE = dict(rtol=1e-6, atol=1e-7)
REDUCED = dict(rtol=1e-5, atol=1e-6)


def _x(seed, *shape, scale=3.0):
    return np32(np.random.RandomState(seed).randn(*shape) * scale)


@pytest.mark.parametrize("name", ["softplus", "softplus_diff",
                                  "softplus_inv"])
def test_softplus(name):
    x = _x(0, 64)
    if name == "softplus_inv":
        x = np.abs(x) + 0.1
    got = tn(getattr(tsp, name)(tt(x)))
    want = np.asarray(getattr(jsp, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **ELEMENTWISE)


@pytest.mark.parametrize("name", ["scale_v2net", "scale_net2v",
                                  "scale_vdiff"])
def test_value_scale(name):
    x = np.concatenate([_x(1, 64, scale=20.0), np32([0.0, 1e-3, -1e-3])])
    got = tn(getattr(tvs, name)(tt(x)))
    want = np.asarray(getattr(jvs, name)(jnp.asarray(x)))
    # both formulas subtract terms larger than their result: scale_net2v
    # two of size ~100 * 51 (a few f32 ulps of 5100 is ~2e-3), scale_vdiff
    # a term near 100 from 100 (a few ulps of 100 is ~3e-5)
    tol = {"scale_net2v": dict(rtol=1e-5, atol=2e-3),
           "scale_vdiff": dict(rtol=1e-6, atol=3e-5)}.get(name, ELEMENTWISE)
    np.testing.assert_allclose(got, want, **tol)


def _policy_inputs(seed, B=32, nA=3, bounded=(True, False, True)):
    rng = np.random.RandomState(seed)
    mean = np32(rng.randn(B, nA) * 3)
    mean[0, 0], mean[1, -1] = 9.0, -9.5    # saturated squashed means
    sraw = np32(rng.randn(B, nA))
    sigma = np32(jsp.softplus(jnp.asarray(sraw)))
    act = np32(rng.randn(B, nA) * 2)
    mu = np.concatenate([np32(rng.randn(B, nA)),
                         np32(np.abs(rng.randn(B, nA)) + 0.2)], axis=-1)
    coef = np32(rng.randn(B))
    return dict(mean=mean, sraw=sraw, sigma=sigma, act=act, mu=mu,
                coef=coef, bounded=np.asarray(bounded))


def test_sigma_and_eff_mean():
    p = _policy_inputs(2)
    np.testing.assert_allclose(tn(tcp.sigma_of(tt(p["sraw"]))),
                               np.asarray(jcp.sigma_of(p["sraw"])),
                               **ELEMENTWISE)
    np.testing.assert_array_equal(
        tn(tcp.eff_mean(tt(p["mean"]), p["bounded"])),
        np.asarray(jcp.eff_mean(p["mean"], p["bounded"])))
    assert tcp.initial_sigma_raw(0.4472135955) == pytest.approx(
        float(jcp.initial_sigma_raw(0.4472135955)), rel=1e-12)


def test_imp_weight_and_logprob():
    p = _policy_inputs(3)
    got = tcp.imp_weight(tt(p["act"]), tt(p["mean"]), tt(p["sigma"]),
                         tt(p["mu"]), p["bounded"])
    want = jcp.imp_weight(p["act"], p["mean"], p["sigma"], p["mu"],
                          p["bounded"])
    np.testing.assert_allclose(tn(got), np.asarray(want), **REDUCED)
    np.testing.assert_allclose(
        tn(tcp.logprob(tt(p["act"]), tt(p["mean"]), tt(p["sigma"]),
                       p["bounded"])),
        np.asarray(jcp.logprob(p["act"], p["mean"], p["sigma"],
                               p["bounded"])), **REDUCED)


@pytest.mark.parametrize("opposite", [True, False])
def test_kl_div(opposite):
    p = _policy_inputs(4)
    got = tcp.kl_div(tt(p["mu"]), tt(p["mean"]), tt(p["sigma"]), opposite)
    want = jcp.kl_div(p["mu"], p["mean"], p["sigma"], opposite)
    np.testing.assert_allclose(tn(got), np.asarray(want), **REDUCED)


def test_pol_grad():
    p = _policy_inputs(5)
    got = tcp.pol_grad(tt(p["act"]), tt(p["mean"]), tt(p["sigma"]),
                       tt(p["sraw"]), tt(p["coef"]), p["bounded"])
    want = jcp.pol_grad(p["act"], p["mean"], p["sigma"], p["sraw"],
                        p["coef"], p["bounded"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(tn(g), np.asarray(w), **ELEMENTWISE)


@pytest.mark.parametrize("opposite", [True, False])
def test_kl_grad(opposite):
    p = _policy_inputs(6)
    got = tcp.kl_grad(tt(p["mu"]), tt(p["mean"]), tt(p["sigma"]),
                      tt(p["sraw"]), tt(p["coef"]), opposite)
    want = jcp.kl_grad(p["mu"], p["mean"], p["sigma"], p["sraw"],
                       p["coef"], opposite)
    for g, w in zip(got, want):
        np.testing.assert_allclose(tn(g), np.asarray(w), **ELEMENTWISE)


def test_pol_grad_matches_autograd():
    """The analytic output gradient equals autograd of coef * log pi on
    unbounded dims (the torch twin of tests/test_policies.py's check)."""
    p = _policy_inputs(7, bounded=(False, False, False))
    mean = tt(p["mean"]).requires_grad_(True)
    sraw = tt(p["sraw"]).requires_grad_(True)
    lp = tcp.logprob(tt(p["act"]), mean, tcp.sigma_of(sraw), p["bounded"])
    (tt(p["coef"]) * lp).sum().backward()
    d_mean, d_sig = tcp.pol_grad(tt(p["act"]), mean.detach(),
                                 tcp.sigma_of(sraw.detach()), sraw.detach(),
                                 tt(p["coef"]), p["bounded"])
    np.testing.assert_allclose(tn(d_mean), tn(mean.grad), **REDUCED)
    np.testing.assert_allclose(tn(d_sig), tn(sraw.grad), **REDUCED)


def test_sample_with_injected_noise_and_mu_vector():
    p = _policy_inputs(8)
    noise = np32(np.random.RandomState(9).randn(*p["mean"].shape))
    got = tcp.sample_with_noise(tt(noise), tt(p["mean"]), tt(p["sigma"]),
                                p["bounded"])
    want = jcp.sample_with_noise(noise, p["mean"], p["sigma"], p["bounded"])
    np.testing.assert_allclose(tn(got), np.asarray(want), **ELEMENTWISE)
    np.testing.assert_array_equal(
        tn(tcp.mu_vector(tt(p["mean"]), tt(p["sigma"]), p["bounded"])),
        np.asarray(jcp.mu_vector(p["mean"], p["sigma"], p["bounded"])))


def test_sample_draws_clipped_noise():
    """sample() = sample_with_noise of clipped normals from the generator:
    |noise| <= NORMDIST_MAX, and the same seed gives the same action."""
    mean = torch.zeros(4096, 1)
    sigma = torch.ones(4096, 1)
    a1 = tcp.sample(torch.Generator().manual_seed(3), mean, sigma, [False])
    a2 = tcp.sample(torch.Generator().manual_seed(3), mean, sigma, [False])
    assert torch.equal(a1, a2)
    assert float(a1.abs().max()) <= tcp.NORMDIST_MAX
    assert abs(float(a1.std()) - 1.0) < 0.1


MDP_KW = dict(dim_state=6, dim_action=2, bounded=(True, False),
              upper_action=(10.0, 2.0), lower_action=(-10.0, -1.0),
              observable=(True, True, False, True, True, True))


@pytest.mark.parametrize("fn", ["observed", "learner_to_env_action",
                                "env_to_learner_action"])
def test_mdp_codec(fn):
    jm, tm = JMDP(**MDP_KW), TMDP(**MDP_KW)
    assert (tm.dim_state_observed, tm.dim_policy, tm.dim_net_input) == (
        jm.dim_state_observed, jm.dim_policy, jm.dim_net_input)
    rng = np.random.RandomState(11)
    if fn == "observed":
        x = np32(rng.randn(5, 6))
    elif fn == "learner_to_env_action":
        x = np32(rng.randn(5, 2) * 2)
    else:
        x = np32(np.stack([rng.uniform(-9.9, 9.9, 5),
                           rng.uniform(-0.9, 1.9, 5)], -1))
    got = tn(getattr(tm, fn)(tt(x)))
    want = np.asarray(getattr(jm, fn)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_klgrad_matches_autograd(seed):
    """The twin of tests/test_policies.py::TestGaussianPolicy::
    test_klgrad_matches_autodiff: the analytic d KL / d outputs equals
    autograd of kl_div, beside test_kl_grad's value parity. kl_div reads
    the unclamped mean, so the JAX test's three bounded cases are one
    function; the twin draws three inputs instead."""
    rng = np.random.RandomState(seed)
    nA = 2
    mean = tt(rng.randn(nA)).requires_grad_(True)
    sraw = tt(rng.randn(nA)).requires_grad_(True)
    mu = torch.cat([tt(rng.randn(nA)),
                    tsp.softplus(tt(rng.randn(nA)))])
    tcp.kl_div(mu, mean, tcp.sigma_of(sraw)).backward()
    d_mean, d_sig = tcp.kl_grad(mu, mean.detach(),
                                tcp.sigma_of(sraw.detach()), sraw.detach(),
                                torch.tensor(1.0))
    np.testing.assert_allclose(tn(d_mean), tn(mean.grad), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tn(d_sig), tn(sraw.grad), rtol=1e-4,
                               atol=1e-5)


def test_vdiff_is_derivative():
    """The twin of tests/test_policies.py::TestValueScale::
    test_vdiff_is_derivative: scale_vdiff is autograd's derivative of
    scale_net2v (f64 here; the JAX test takes central differences)."""
    x = torch.linspace(-2, 2, 21, dtype=torch.float64).requires_grad_(True)
    tvs.scale_net2v(x).sum().backward()
    np.testing.assert_allclose(tn(tvs.scale_vdiff(x.detach())),
                               tn(x.grad), rtol=1e-3, atol=1e-3)

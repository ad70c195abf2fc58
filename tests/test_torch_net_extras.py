"""Port parity of the net library's extras: the twin of
tests/test_net_extras.py (HardSigmoid / SoftRBF / ExpPlus, the output
bias set through an activation's inverse, residual connections, join;
Network/Layers/Functions.h:255-525, Layer_Base.h:122-125,
Layers.h:421-470).

Every activation of the port's table against the JAX table on the same
f32 inputs (rtol 1e-6: the same formula, a few ulps for transcendental
functions; ExpPlus 1e-5 as the JAX test holds it against numpy), the
inverses' round trips, a net with each new activation against the JAX
net on converted parameters (rtol 1e-5 / atol 1e-6, as
test_torch_net_optim.py's nets), the output bias through each inverse,
the residual skip (and that autograd flows through it) and join.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.models import net as jnet
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models import net as tnet

from _torch_parity import np32, tn, tt

NETS = dict(rtol=1e-5, atol=1e-6)
NEW_ACTS = ("HardSigmoid", "SoftRBF", "ExpPlus")
INVERTIBLE = ("Linear", "Tanh", "Sigm", "SoftSign", "HardSign",
              "HardSigmoid", "SoftPlus", "ExpPlus", "Exp")


def test_tables_have_the_same_entries():
    assert sorted(tnet._ACTS) == sorted(jnet._ACTS)
    assert sorted(tnet._INVERSE) == sorted(jnet._INVERSE)


@pytest.mark.parametrize("name", sorted(jnet._ACTS))
def test_activation_matches_jax(name):
    x = np.concatenate([np.linspace(-3, 3, 41),
                        np.random.RandomState(0).randn(64) * 4])
    x = np32(x)
    got = tn(tnet._ACTS[name](tt(x)))
    want = np.asarray(jnet._ACTS[name](jnp.asarray(x)))
    rtol = 1e-5 if name == "ExpPlus" else 1e-6
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7)


def test_new_activations_match_reference_formulas():
    x = np.linspace(-3, 3, 41)
    np.testing.assert_allclose(tn(tnet._ACTS["HardSigmoid"](tt(x))),
                               0.5 * (1 + x / np.sqrt(1 + x * x)), rtol=1e-6)
    np.testing.assert_allclose(tn(tnet._ACTS["SoftRBF"](tt(x))),
                               1 / (1 + x * x), rtol=1e-6)
    np.testing.assert_allclose(tn(tnet._ACTS["ExpPlus"](tt(x))),
                               np.log1p(np.exp(x)), rtol=1e-5)


@pytest.mark.parametrize("name", INVERTIBLE)
def test_inverse_roundtrip(name):
    y = np.asarray([0.12, 0.4, 0.73])       # in every activation's range
    x = tnet._INVERSE[name](y)
    np.testing.assert_allclose(x, jnet._INVERSE[name](y), rtol=1e-12)
    np.testing.assert_allclose(tn(tnet._ACTS[name](tt(x))), y, rtol=1e-4,
                               atol=1e-5, err_msg=name)


def _both(spec_kw, seed):
    """The JAX net's parameters and the same ones converted for the port."""
    jp = jnet.init_params(jax.random.PRNGKey(seed), jnet.NetSpec(**spec_kw))
    return jp, convert.params_from_jax(jax.device_get(jp))


@pytest.mark.parametrize("act", NEW_ACTS)
def test_net_with_new_activation_matches_jax(act):
    kw = dict(n_in=4, hidden=(8, 8), n_out=3, act=act)
    jp, tp = _both(kw, 0)
    x = np32(np.random.RandomState(1).randn(5, 4))
    want, _ = jnet.apply_net(jp, jnet.NetSpec(**kw), jnp.asarray(x))
    got, _ = tnet.apply_net(tp, tnet.NetSpec(**kw), tt(x))
    assert got.shape == (5, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(tn(got), np.asarray(want), **NETS)


@pytest.mark.parametrize("out_act", INVERTIBLE)
def test_output_bias_through_inverse(out_act):
    """Layer_Base.h:122-125: the output bias is the activation's inverse
    of the requested values, so with the hidden output zeroed the net
    outputs them; the port's bias equals the JAX package's."""
    want = (0.3, 0.7)
    kw = dict(n_in=4, hidden=(8,), n_out=2, out_act=out_act,
              out_bias_init=want)
    p = tnet.init_params(torch.Generator().manual_seed(0),
                         tnet.NetSpec(**kw))
    jp = jnet.init_params(jax.random.PRNGKey(0), jnet.NetSpec(**kw))
    np.testing.assert_allclose(tn(p["out"]["b"]), np.asarray(jp["out"]["b"]),
                               rtol=1e-6)
    y = tnet._ACTS[out_act](torch.zeros(2) @ torch.zeros(2, 2)
                            + p["out"]["b"].detach())
    np.testing.assert_allclose(tn(y), want, rtol=1e-5)


def test_residual_adds_skip_as_jax_does():
    kw = dict(n_in=4, hidden=(8, 8, 8), n_out=2)
    jp, tp = _both(dict(kw, residual=True), 1)
    x = np.ones((3, 4), np.float32)
    y_r, _ = tnet.apply_net(tp, tnet.NetSpec(**kw, residual=True), tt(x))
    y_p, _ = tnet.apply_net(tp, tnet.NetSpec(**kw, residual=False), tt(x))
    assert not np.allclose(tn(y_r), tn(y_p))
    want, _ = jnet.apply_net(jp, jnet.NetSpec(**kw, residual=True),
                             jnp.asarray(x))
    np.testing.assert_allclose(tn(y_r), np.asarray(want), **NETS)
    # the gradient flows through the skip path, as jax.grad's does
    y_r.sum().backward()
    g = tp["layers"][0]["W"].grad
    jg = jax.grad(lambda pp: jnp.sum(jnet.apply_net(
        pp, jnet.NetSpec(**kw, residual=True), jnp.asarray(x))[0]))(jp)
    assert torch.isfinite(g).all()
    np.testing.assert_allclose(tn(g), np.asarray(jg["layers"][0]["W"]),
                               **NETS)


def test_join_concats():
    a, b = torch.ones((3, 2)), torch.zeros((3, 4))
    out = tnet.join(a, b)
    assert out.shape == (3, 6)
    np.testing.assert_array_equal(tn(out), np.asarray(jnet.join(
        jnp.ones((3, 2)), jnp.zeros((3, 4)))))

"""Port parity: the FFNN, its pullback, Adam, and the param converter.

Parameters made by the JAX package's init_params are converted with
smarties_tpu_torch.models.convert and fed to both frameworks. The net is
a chain of f32 matmuls whose reductions run in another order in each
framework: rtol 1e-5 / atol 1e-6 on outputs and gradients. Adam is
elementwise on identical inputs: rtol 1e-6 / atol 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.models import net as jnet
from smarties_tpu.models import optim as jopt
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models import net as tnet
from smarties_tpu_torch.models import optim as topt

from _torch_parity import assert_tree_close, np32, tn, tt

NET_TOL = dict(rtol=1e-5, atol=1e-6)
ADAM_TOL = dict(rtol=1e-6, atol=1e-9)

SPEC_KW = dict(n_in=5, hidden=(16, 16), n_out=2, n_param_out=1,
               param_init=(0.3,), out_bias_init=(0.0, 0.25))


def _params(seed=0):
    spec = jnet.NetSpec(**SPEC_KW)
    return spec, jax.device_get(jnet.init_params(jax.random.PRNGKey(seed),
                                                 spec))


def test_init_params_conventions():
    """Same tree, shapes, biases and param head; weights within the
    reference's U(-f, f) bounds."""
    spec, pj = _params()
    pt = tnet.init_params(torch.Generator().manual_seed(0),
                          tnet.NetSpec(**SPEC_KW))
    assert jax.tree_util.tree_structure(pj) == jax.tree_util.tree_structure(
        convert.params_to_jax(pt))
    for a, b in zip(jax.tree_util.tree_leaves(pj), tnet.tree_leaves(pt)):
        assert a.shape == tuple(b.shape)
        assert b.requires_grad
    np.testing.assert_array_equal(tn(pt["out"]["b"]), pj["out"]["b"])
    np.testing.assert_array_equal(tn(pt["param"]), pj["param"])
    fac = np.sqrt(6.0 / (5 + 16))
    w_max = float(pt["layers"][0]["W"].detach().abs().max())
    assert 0.5 * fac < w_max <= fac


def test_params_round_trip():
    _, pj = _params(1)
    back = convert.params_to_jax(convert.params_from_jax(pj))
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(pj)
    for a, b in zip(jax.tree_util.tree_leaves(pj),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("act", ["SoftSign", "Tanh", "Relu"])
def test_apply_net(act):
    kw = dict(SPEC_KW, act=act)
    sj = jnet.NetSpec(**kw)
    pj = jax.device_get(jnet.init_params(jax.random.PRNGKey(2), sj))
    x = np32(np.random.RandomState(3).randn(64, 5))
    want, _ = jnet.apply_net(pj, sj, jnp.asarray(x))
    got, _ = tnet.apply_net(convert.params_from_jax(pj),
                            tnet.NetSpec(**kw), tt(x))
    np.testing.assert_allclose(tn(got), np.asarray(want), **NET_TOL)


def test_pullback_matches_vjp():
    """A fixed output cotangent pulled back through autograd
    (out.backward(gradient=g)) equals jax.vjp's parameter cotangent."""
    spec, pj = _params(4)
    rng = np.random.RandomState(5)
    x = np32(rng.randn(48, 5))
    g = np32(rng.randn(48, spec.total_out))
    _, vjp = jax.vjp(lambda p: jnet.apply_net(p, spec, jnp.asarray(x))[0],
                     jax.tree_util.tree_map(jnp.asarray, pj))
    want = jax.device_get(vjp(jnp.asarray(g))[0])
    pt = convert.params_from_jax(pj)
    out, _ = tnet.apply_net(pt, tnet.NetSpec(**SPEC_KW), tt(x))
    out.backward(gradient=tt(g))
    assert_tree_close(tnet.tree_map(lambda p: p.grad, pt), want, **NET_TOL)


@pytest.mark.parametrize("lam,eps_anneal", [(0.0, 0.0), (1e-3, 5e-3)])
def test_adam_steps(lam, eps_anneal):
    """Three Adam ascent steps from the same params and gradients: params,
    both moments, the beta_t powers and the step counter."""
    _, pj = _params(6)
    rng = np.random.RandomState(7)
    grads = [jax.tree_util.tree_map(
        lambda x: np32(rng.randn(*x.shape)), pj) for _ in range(3)]
    jcfg = jopt.AdamConfig(eta=1e-3, lambda_=lam, eps_anneal=eps_anneal)
    tcfg = topt.AdamConfig(eta=1e-3, lambda_=lam, eps_anneal=eps_anneal)
    jp = jax.tree_util.tree_map(jnp.asarray, pj)
    js = jopt.adam_init(jp)
    tp = convert.params_from_jax(pj)
    ts = convert.adam_state_from_jax(jax.device_get(js))
    for g in grads:
        jp, js = jopt.adam_step(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                js, jcfg, 1.0 / 32)
        tp, ts = topt.adam_step(tp, tnet.tree_map(tt, g), ts, tcfg, 1.0 / 32)
    assert_tree_close(tp, jax.device_get(jp), **ADAM_TOL)
    assert_tree_close(ts.m1, jax.device_get(js.m1), **ADAM_TOL)
    assert_tree_close(ts.m2, jax.device_get(js.m2), **ADAM_TOL)
    np.testing.assert_allclose(float(ts.beta_t_1), float(js.beta_t_1),
                               rtol=1e-7)
    np.testing.assert_allclose(float(ts.beta_t_2), float(js.beta_t_2),
                               rtol=1e-7)
    assert int(ts.step) == int(js.step) == 3
    # updated in place: the port's leaves are still the graph leaves
    assert all(p.is_leaf and p.requires_grad for p in tnet.tree_leaves(tp))


def test_adam_state_from_jax_dict():
    _, pj = _params(8)
    js = jax.device_get(jopt.adam_init(jax.tree_util.tree_map(jnp.asarray,
                                                              pj)))
    ts = convert.adam_state_from_jax(js._asdict())
    assert int(ts.step) == 0 and ts.step.dtype == torch.int32
    assert float(ts.beta_t_1) == pytest.approx(0.9)
    assert_tree_close(ts.m1, js.m1, rtol=0, atol=0)

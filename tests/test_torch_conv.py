"""Port parity: the conv preprocessing stack of models/net.py.

The same parameters (made by the JAX package's init_params and carried
over by models/convert.py, a plain copy: both sides keep HWIO conv
leaves) and the same inputs, made from a seed with numpy, go through the
JAX apply_net and the port's. The JAX package rewrites the first layer as
a space-to-depth stride-1 conv by default (the same index set summed in
another order) and runs the plain strided conv with SMT_NO_S2D=1; the
port is held against both.

Tolerances. Forward at 20x20x3 with two layers: rtol 1e-5 / atol 1e-6
against either JAX form (sums of at most 75 and 128 f32 products).
Gradients of a scalar loss with respect to every leaf: rtol 1e-4 / atol
1e-6 (the weight gradients sum over batch and positions in another
order). At the Mnih shapes (84x84x4 -> 32.8/4, 64.4/2, 64.3/1 -> [512])
with batch 2, forward only: rtol 1e-4 / atol 1e-5, the dense layer sums
3136 products.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.models import net as jnet
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models import net as tnet

from _torch_parity import assert_tree_close, np32, tn, tt

SMALL = ((20, 20, 3, 4, 4, 2), (9, 9, 4, 8, 3, 2))
MNIH = ((84, 84, 4, 32, 8, 4), (20, 20, 32, 64, 4, 2), (9, 9, 64, 64, 3, 1))
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
MNIH_TOL = dict(rtol=1e-4, atol=1e-5)


def _specs(conv, hidden, n_out, **kw):
    n_in = conv[0][0] * conv[0][1] * conv[0][2]
    js = jnet.NetSpec(n_in=n_in, hidden=hidden, n_out=n_out,
                      conv=tuple(jnet.Conv2DDesc(*c) for c in conv), **kw)
    ts = tnet.NetSpec(n_in=n_in, hidden=hidden, n_out=n_out,
                      conv=tuple(tnet.Conv2DDesc(*c) for c in conv), **kw)
    return js, ts


def _s2d(monkeypatch, on):
    if on:
        monkeypatch.delenv("SMT_NO_S2D", raising=False)
    else:
        monkeypatch.setenv("SMT_NO_S2D", "1")


@pytest.mark.parametrize("desc", [(84, 84, 4, 32, 8, 4), (20, 20, 32, 64, 4, 2),
                                  (9, 9, 64, 64, 3, 1), (20, 20, 3, 4, 4, 2),
                                  (12, 12, 2, 4, 4, 2), (5, 5, 4, 8, 3, 2)])
def test_conv_desc_sizes(desc):
    j, t = jnet.Conv2DDesc(*desc), tnet.Conv2DDesc(*desc)
    assert (t.out_w, t.out_h) == (j.out_w, j.out_h)
    assert tuple(getattr(t, f) for f in ("in_w", "in_h", "in_c", "out_c",
                                         "filter", "stride")) == desc


def test_mlp_in_dim():
    js, ts = _specs(MNIH, (512,), 6)
    assert tnet._mlp_in_dim(ts) == jnet._mlp_in_dim(js) == 7 * 7 * 64
    plain = tnet.NetSpec(n_in=5, hidden=(4,), n_out=1)
    assert tnet._mlp_in_dim(plain) == 5


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "no_s2d"])
def test_forward_small(monkeypatch, s2d):
    """[frame0; frame1; frame2] flat input, two conv layers, a dense
    layer and a param head; leading batch axes of rank 1 and 2."""
    _s2d(monkeypatch, s2d)
    js, ts = _specs(SMALL, (16,), 5, n_param_out=2, param_init=(0.3, 0.4))
    assert bool(jnet._s2d_stride(js.conv[0])) == s2d
    params = jnet.init_params(jax.random.PRNGKey(1), js)
    tp = convert.params_from_jax(jax.device_get(params))
    rng = np.random.RandomState(0)
    for shape in ((7,), (2, 3)):
        x = np32(rng.randn(*shape, js.n_in))
        want, _ = jnet.apply_net(params, js, jnp.asarray(x))
        got, carry = tnet.apply_net(tp, ts, tt(x))
        assert carry == () and got.shape == shape + (7,)
        np.testing.assert_allclose(tn(got), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "no_s2d"])
def test_gradients_small(monkeypatch, s2d):
    """d(sum(y * c))/d(leaf) for every leaf, conv weights and biases
    included."""
    _s2d(monkeypatch, s2d)
    js, ts = _specs(SMALL, (16,), 5)
    params = jnet.init_params(jax.random.PRNGKey(2), js)
    tp = convert.params_from_jax(jax.device_get(params))
    rng = np.random.RandomState(1)
    x = np32(rng.randn(6, js.n_in))
    c = np32(rng.randn(6, 5))
    want = jax.grad(lambda p: jnp.sum(
        jnet.apply_net(p, js, jnp.asarray(x))[0] * jnp.asarray(c)))(params)
    y, _ = tnet.apply_net(tp, ts, tt(x))
    torch.sum(y * tt(c)).backward()
    got = tnet.tree_map(lambda p: p.grad, tp)
    assert_tree_close(got, jax.device_get(want), **GRAD_TOL)
    assert all(float(g.abs().max()) > 0 for g in tnet.tree_leaves(got))


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "no_s2d"])
def test_forward_mnih(monkeypatch, s2d):
    """The Atari recipe's shapes, batch 2, pixel-range inputs
    standardized as the gather does."""
    _s2d(monkeypatch, s2d)
    js, ts = _specs(MNIH, (512,), 13)
    params = jnet.init_params(jax.random.PRNGKey(3), js)
    tp = convert.params_from_jax(jax.device_get(params))
    rng = np.random.RandomState(2)
    x = np32((rng.randint(0, 256, (2, js.n_in)) - 128.0) / 64.0)
    want, _ = jnet.apply_net(params, js, jnp.asarray(x))
    got, _ = tnet.apply_net(tp, ts, tt(x))
    np.testing.assert_allclose(tn(got), np.asarray(want), **MNIH_TOL)


def test_frames_are_channels():
    """Two different frames map to different channel planes: swapping
    them changes the output (tests/test_conv_stack.py), and the port's
    answer to either order is the JAX package's."""
    W = 12
    js, ts = _specs(((W, W, 2, 2, 3, 1),), (4,), 1)
    params = jnet.init_params(jax.random.PRNGKey(0), js)
    tp = convert.params_from_jax(jax.device_get(params))
    f0, f1 = np.ones((1, W * W), np.float32), np.zeros((1, W * W),
                                                       np.float32)
    outs = []
    for x in (np.concatenate([f0, f1], -1), np.concatenate([f1, f0], -1)):
        want, _ = jnet.apply_net(params, js, jnp.asarray(x))
        got, _ = tnet.apply_net(tp, ts, tt(x))
        np.testing.assert_allclose(tn(got), np.asarray(want), **FWD_TOL)
        outs.append(tn(got))
    assert not np.allclose(outs[0], outs[1])


def test_flatten_order_is_hwc():
    """The conv output reaches the dense layer in (h, w, c) order: with
    an identity-like 1x1 conv the dense input is the NHWC image."""
    spec = tnet.NetSpec(n_in=2 * 3 * 3, hidden=(), n_out=18, act="Linear",
                        out_prefac=1.0,
                        conv=(tnet.Conv2DDesc(3, 3, 2, 2, 1, 1),))
    params = {"conv": [{"W": torch.eye(2).reshape(1, 1, 2, 2),
                        "b": torch.zeros(2)}],
              "layers": [], "out": {"W": torch.eye(18),
                                    "b": torch.zeros(18)}}
    x = torch.arange(1.0, 19.0)[None]          # CHW, positive: LRelu is id
    y, _ = tnet.apply_net(params, spec, x)
    want = x.reshape(1, 2, 3, 3).permute(0, 2, 3, 1).reshape(1, -1)
    assert torch.equal(y, want)


def test_init_ranges_and_shapes():
    """Conv leaves: W [K, K, Cin, O] ~ U(-f, f) with f = sqrt(2 / (K K
    Cin)) (the Relu factor), b zero, the first dense layer sized by the
    conv output; a dense net's init does not change when another spec
    has a conv stack."""
    js, ts = _specs(MNIH, (512,), 6)
    tp = tnet.init_params(torch.Generator().manual_seed(0), ts)
    jp = jax.device_get(jnet.init_params(jax.random.PRNGKey(0), js))
    assert (jax.tree_util.tree_structure(tnet.tree_map(tn, tp))
            == jax.tree_util.tree_structure(jp))
    for tl, jl, c in zip(tp["conv"], jp["conv"], ts.conv):
        assert tuple(tl["W"].shape) == jl["W"].shape == (
            c.filter, c.filter, c.in_c, c.out_c)
        f = np.sqrt(2.0 / (c.filter * c.filter * c.in_c))
        w = tn(tl["W"])
        assert np.abs(w).max() <= f and np.abs(w).max() > 0.9 * f
        assert abs(w.mean()) < 0.05 * f
        np.testing.assert_allclose(np.abs(jl["W"]).max(), np.abs(w).max(),
                                   rtol=0.1)
        assert not tn(tl["b"]).any() and tl["W"].requires_grad
    assert tuple(tp["layers"][0]["W"].shape) == (3136, 512)
    dense = tnet.NetSpec(n_in=3136, hidden=(512,), n_out=6)
    dp = tnet.init_params(torch.Generator().manual_seed(0), dense)
    assert torch.equal(dp["layers"][0]["W"], tp["layers"][0]["W"])
    assert torch.equal(dp["out"]["W"], tp["out"]["W"])


def test_convert_round_trip():
    """Conv leaves cross both ways unchanged, alone, in {"net", "tgt"}
    trees and as Adam moments."""
    from smarties_tpu.models.optim import adam_init
    js, ts = _specs(SMALL, (8,), 3)
    params = jnet.init_params(jax.random.PRNGKey(4), js)
    tp = convert.params_from_jax(jax.device_get(params))
    assert_tree_close(tp, jax.device_get(params), rtol=0, atol=0)
    back = convert.params_to_jax(tp)
    assert_tree_close(convert.params_from_jax(back), back, rtol=0, atol=0)
    assert back["conv"][1]["W"].shape == (3, 3, 4, 8)
    both = convert.params_from_jax({"net": back, "tgt": back})
    assert all(x.requires_grad for x in tnet.tree_leaves(both["net"]))
    assert not any(x.requires_grad for x in tnet.tree_leaves(both["tgt"]))
    opt = jax.device_get(adam_init(params))
    m1 = jax.tree_util.tree_map(lambda x: x + 0.5, opt.m1)
    to = convert.adam_state_from_jax(opt._replace(m1=m1))
    assert_tree_close(to.m1, m1, rtol=0, atol=0)
    assert convert.opt_state_to_numpy(to)["m1"]["conv"][0]["W"].shape == (
        4, 4, 3, 4)

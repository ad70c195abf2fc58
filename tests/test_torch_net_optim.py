"""Port parity: the FFNN, its pullback, Adam (on feed-forward and
recurrent leaves), and the param converter; the Adam kernel's arithmetic
(csrc/adam.cu) emulated in numpy float32 against the loop it replaces on
the card, and its wrapper's refusals.

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
from smarties_tpu_torch.ops import adam_kernel, cuda_lib

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


@pytest.mark.parametrize("kind", ["RNN", "LSTM", "GRU"])
def test_adam_steps_on_recurrent_leaves(kind):
    """The recurrent layers' leaves (12 per LSTM layer, 6 per GRU layer)
    cross both ways in the JAX leaf order, and two Adam steps move every
    one of them as the JAX package's do."""
    kw = dict(SPEC_KW, kind=kind)
    sj = jnet.NetSpec(**kw)
    pj = jax.device_get(jnet.init_params(jax.random.PRNGKey(9), sj))
    tp = convert.params_from_jax(pj)
    n_leaves = {"RNN": 3, "LSTM": 12, "GRU": 6}[kind]
    assert all(len(layer) == n_leaves for layer in tp["layers"])
    assert [tuple(x.shape) for x in tnet.tree_leaves(tp)] == \
        [x.shape for x in jax.tree_util.tree_leaves(pj)]
    assert_tree_close(tp, convert.params_to_jax(tp), rtol=0, atol=0)
    rng = np.random.RandomState(10)
    cfg = dict(eta=1e-3, lambda_=1e-3, eps_anneal=5e-3)
    jp = jax.tree_util.tree_map(jnp.asarray, pj)
    js = jopt.adam_init(jp)
    ts = convert.adam_state_from_jax(jax.device_get(js))
    for _ in range(2):
        g = jax.tree_util.tree_map(lambda x: np32(rng.randn(*x.shape)), pj)
        jp, js = jopt.adam_step(jp, jax.tree_util.tree_map(jnp.asarray, g),
                                js, jopt.AdamConfig(**cfg), 1.0 / 32)
        tp, ts = topt.adam_step(tp, tnet.tree_map(tt, g), ts,
                                topt.AdamConfig(**cfg), 1.0 / 32)
    assert_tree_close(tp, jax.device_get(jp), **ADAM_TOL)
    assert_tree_close(ts.m2, jax.device_get(js.m2), **ADAM_TOL)
    assert all((tn(a) != b).any() for a, b in zip(
        tnet.tree_leaves(tp), jax.tree_util.tree_leaves(pj)))


def test_adam_cpu_leaves_take_the_loop():
    """CPU leaves run the plain loop: the kernel is neither built nor
    launched, and the result is the loop's own. Its counter is one that a
    graph replay advances."""
    _, pj = _params(11)
    rng = np.random.RandomState(12)
    cfg = topt.AdamConfig(eta=1e-3, lambda_=1e-3, eps_anneal=5e-3)
    tp = convert.params_from_jax(pj)
    pp = convert.params_from_jax(pj)
    ts, ps = topt.adam_init(tp), topt.adam_init(pp)
    cuda_lib.reset_launches()
    for _ in range(3):
        g = tnet.tree_map(lambda x: tt(rng.randn(*x.shape)), tp)
        topt.adam_step(tp, g, ts, cfg, 1.0 / 32)
        topt.adam_update_plain_(pp, g, ps, cfg, 1.0 / 32)
        topt.adam_advance_plain_(ps, cfg)
    assert adam_kernel.launches == {"adam_update": 0, "adam_advance": 0}
    assert not adam_kernel.LIB.loaded
    assert any(adam_kernel.launches is c for c in cuda_lib.COUNTERS)
    for a, b in zip(tnet.tree_leaves([tp, list(ts)]),
                    tnet.tree_leaves([pp, list(ps)])):
        assert torch.equal(a, b)


def _torch_cpu_sqrt(x):
    """PyTorch's float32 sqrt on the CPU, on an array of x's shape: on an
    AVX-512 host it is not correctly rounded (an ulp off for about 0.6%
    of inputs), while the card's torch.sqrt and the kernel's __fsqrt_rn
    are. The emulation takes the square root from the loop's device, so
    that everything else is held bit for bit."""
    return torch.sqrt(torch.from_numpy(np.array(x, np.float32))).numpy()


def _emulated_adam_step(ws, gs, m1s, m2s, scal, args, b1, b2, eps):
    """csrc/adam.cu's update and advance in numpy float32, operation by
    operation: ws / m1s / m2s lists of float32 arrays, updated in place;
    scal = [beta_t_1, beta_t_2, step] as numpy scalars, replaced."""
    f, sqrt = np.float32, _torch_cpu_sqrt
    gf, c1, omb1, c2, omb2, e, lam, eta, time_inv = args
    bt1, bt2, step = scal
    den = f(step) * time_inv + f(1)
    eta_t = ((f(1) / den) * eta) * sqrt(f(1) - bt2) / (f(1) - bt1)
    for w, g, m1, m2 in zip(ws, gs, m1s, m2s):
        dw = gf * g
        m1[...] = c1 * m1 + omb1 * dw
        m2[...] = np.maximum(c2 * m2 + (omb2 * dw) * dw, m1 * m1)
        ret = (c1 * m1 + omb1 * dw) / (sqrt(m2) + e)
        w[...] = w + eta_t * (ret + (-w) * lam)
    bt1, bt2 = bt1 * f(b1), bt2 * f(b2)
    scal[:] = [f(0) if bt1 < f(eps) else bt1, f(0) if bt2 < f(eps) else bt2,
               step + 1]


@pytest.mark.parametrize("cfg", [
    dict(eta=1e-4),
    dict(eta=1e-3, lambda_=1e-3, eps_anneal=5e-3),
    dict(eta=3e-3, lambda_=1e-4, eps_anneal=5e-3, anneal_lr=False),
    dict(eta=1e-3, beta1=0.8, beta2=0.99, eps_anneal=1e-2)],
    ids=["default", "lambda_anneal", "anneal_off", "betas"])
def test_adam_kernel_arithmetic_equals_the_loop(cfg):
    """The kernel's operation sequence, emulated in numpy float32 and fed
    the wrapper's own float32 arguments (adam_kernel.scalar_args), is
    array_equal to the loop over 20 steps at leaves of 1, 2, 768 and
    16384 elements: the constants' rounding, eta_t's order (reciprocal
    then eta, the sqrt, the division), the maximum, the Nesterov numerator
    and the decay are the loop's. The square root is the loop's device's
    (_torch_cpu_sqrt); on the card tests/test_torch_adam_cuda.py holds the
    kernel itself against the loop."""
    tcfg = topt.AdamConfig(**cfg)
    rng = np.random.RandomState(13)
    shapes = [(1,), (2,), (6, 128), (128, 128)]
    params = {f"l{i}": tt(rng.randn(*s) * 0.3) for i, s in enumerate(shapes)}
    state = topt.adam_init(params)
    ws = [tn(x).copy() for x in params.values()]
    m1s = [np.zeros_like(w) for w in ws]
    m2s = [np.zeros_like(w) for w in ws]
    scal = [np.float32(0.9), np.float32(0.999), 0]
    gf = 1.0 / 256
    args = adam_kernel.scalar_args(tcfg, gf, topt.NN_EPS)
    assert all(type(a) is np.float32 for a in args)
    for k in range(20):
        gs = [np32(rng.randn(*s) * (10.0 if k % 7 == 3 else 1.0))
              for s in shapes]
        topt.adam_step(params, {k: tt(g) for k, g in zip(params, gs)},
                       state, tcfg, gf)
        _emulated_adam_step(ws, gs, m1s, m2s, scal, args, tcfg.beta1,
                            tcfg.beta2, topt.NN_EPS)
        for w, m1, m2, x, y, z in zip(ws, m1s, m2s, params.values(),
                                      state.m1.values(), state.m2.values()):
            np.testing.assert_array_equal(tn(x), w)
            np.testing.assert_array_equal(tn(y), m1)
            np.testing.assert_array_equal(tn(z), m2)
        np.testing.assert_array_equal(tn(state.beta_t_1), scal[0])
        np.testing.assert_array_equal(tn(state.beta_t_2), scal[1])
        assert int(state.step) == scal[2] == k + 1


def _leaf_set(**bad):
    """One leaf's (ws, gs, m1s, m2s) lists, a part replaced by `bad`."""
    sets = dict(w=torch.zeros(4, 3), g=torch.ones(4, 3),
                m1=torch.zeros(4, 3), m2=torch.zeros(4, 3))
    sets.update(bad)
    return [[sets[k]] for k in ("w", "g", "m1", "m2")]


@pytest.mark.parametrize("bad", [
    dict(g=torch.ones(3, 4).t()),
    dict(w=torch.zeros(4, 3, dtype=torch.float64)),
    dict(m2=torch.zeros(4, 3, device="meta")),
    dict(g=torch.ones(12)),
    dict(m1=torch.zeros(4, 3, dtype=torch.bfloat16))],
    ids=["non_contiguous", "f64", "mixed_device", "grad_shape", "bf16"])
def test_adam_kernel_refuses(bad):
    """The wrapper raises on what the kernel does not take, before any
    build or launch: there is no fallback."""
    state = topt.adam_init({"w": torch.zeros(4, 3)})
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="adam_kernel"):
        adam_kernel.update_(*_leaf_set(**bad), state, topt.AdamConfig(),
                            1.0, topt.NN_EPS)
    assert adam_kernel.launches["adam_update"] == 0


def test_adam_kernel_refuses_scalars():
    """The 0-d scalars must be float32 / int32 on the leaves' device."""
    st = topt.adam_init({"w": torch.zeros(4, 3)})
    for bad in (st._replace(step=st.step.to(torch.int64)),
                st._replace(beta_t_1=st.beta_t_1.double()),
                st._replace(beta_t_2=torch.zeros((), device="meta"))):
        with pytest.raises(ValueError, match="adam_kernel"):
            adam_kernel.update_(*_leaf_set(), bad, topt.AdamConfig(), 1.0,
                                topt.NN_EPS)
        with pytest.raises(ValueError, match="adam_kernel"):
            adam_kernel.advance_(bad, topt.AdamConfig(), topt.NN_EPS)

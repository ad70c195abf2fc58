"""Port parity: the nnBf16 compute type (NetSpec.compute_dtype
"bfloat16", models/net.py) against the JAX package's.

The dense and conv contractions run with both operands in bf16 and the
product rounded to bf16, then cast back to f32; everything else stays
f32. The same parameters (the JAX package's init, carried over by
models/convert.py) and the same inputs, made from a seed with numpy, go
through both packages. The JAX side runs its plain strided conv
(SMT_NO_S2D=1, set by monkeypatch), as the port does; one case runs its
default space-to-depth first layer, at the 2e-2 of the JAX package's own
tests/test_s2d_conv.py.

Tolerances, from the measured gaps on this CPU (JAX 0.9, torch 2.13):
- nets (FFNN, residual FFNN, LSTM, the small conv stack): forward and
  the gradient of every leaf rtol 4e-3 (one bf16 ulp, 2^-8, should a
  rounding fall the other way) / atol 1e-5. Measured: forward bit-equal,
  gradients within 2.4e-7. The port's f32 forward misses the JAX bf16
  one by 8.2e-5 to 3.6e-4 and its gradients by 3.6e-3 to 1.6e-2, out of
  these tolerances in every case (asserted);
- 4 pinned train steps (RACER-discrete and DQN on the small image MDP of
  tests/test_torch_learners_conv.py, V-RACER, RACER-Gaussian, DQN): params rtol 1e-5 / atol 1e-6 (measured
  1.7e-8 at most past rtol 1e-5, 2.0e-7 on a replay without the short
  episodes: a gradient element rounded to the other bf16 neighbour moves
  its Adam step by up to ~4e-7); Adam moments rtol 1e-3 / atol 1e-6 on m1
  (2.6e-7, the conv case) and 1e-9 on m2 (7.7e-11). The port in f32 is
  4.0e-6 to 1.2e-4 past the params' rtol and 9.4e-6 to 1.4e-4 past m1's
  (asserted out of tolerance);
- RACER-ES: the population and ES state rtol 1e-5 / atol 1e-6 (bit-equal
  here, in f32 too: the update depends on the members' ranking only), rho
  and advantage rtol 1e-4 / atol 1e-5, KL rtol 1e-4 / atol 1e-6 (measured
  3.0e-8), values atol 2e-3 (scale_net2v cancels two terms near 5100).
  The port in f32 is 1.5e-5 past that KL tolerance (asserted);
- NAF, DPG, MixedPG, PPO and ACER ignore nnBf16 in the JAX package: with
  the flag on and off the port's Trainer gives torch.equal params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.envs import cartpole as jc
from smarties_tpu.models import net as jnet
from smarties_tpu.replay import buffer as jrb
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos.cma import Unravel, ravel
from smarties_tpu_torch.algos.registry import make_learner as tmake
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models import net as tnet
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_learner_cases import (BASE, CONV_CASES, MOMENT_TOL, POLICY_TOL,
                                  VALUE_TOL, _img_mdps, _jax_replay,
                                  _jax_replay_img, _mdp, _opt_parts, _pinned,
                                  assert_replay_close, assert_tree_close,
                                  jax_replay_views, np32, tn, tt)

NET_TOL = dict(rtol=4e-3, atol=1e-5)
PARAM_TOL_BF16 = dict(rtol=1e-5, atol=1e-6)
S2D_TOL = dict(rtol=2e-2, atol=2e-2)
MOMENT_TOL_BF16 = dict(rtol=1e-3, atol=1e-6)
SMALL = ((20, 20, 3, 4, 4, 2), (9, 9, 4, 8, 3, 2))
NETS = {
    "ffnn": dict(n_in=24, hidden=(64, 64), n_out=5, n_param_out=2,
                 param_init=(0.3, 0.4)),
    "residual": dict(n_in=24, hidden=(64, 64, 64), n_out=5, residual=True),
    "lstm": dict(n_in=24, hidden=(16, 16), n_out=5, kind="LSTM"),
    "conv": dict(n_in=20 * 20 * 3, hidden=(16,), n_out=5, conv=SMALL),
}


def _s2d(monkeypatch, on):
    if on:
        monkeypatch.delenv("SMT_NO_S2D", raising=False)
    else:
        monkeypatch.setenv("SMT_NO_S2D", "1")


def _specs(compute_dtype, conv=(), **kw):
    js = jnet.NetSpec(conv=tuple(jnet.Conv2DDesc(*c) for c in conv),
                      compute_dtype=compute_dtype, **kw)
    ts = tnet.NetSpec(conv=tuple(tnet.Conv2DDesc(*c) for c in conv),
                      compute_dtype=compute_dtype, **kw)
    return js, ts


def _misses(got, want, tol):
    return not np.allclose(got, want, **tol)


def _tree_misses(got, want, tol):
    """Some leaf of the port's tree is out of `tol` of the JAX one's."""
    return any(_misses(tn(a), np.asarray(b), tol) for a, b in zip(
        tnet.tree_leaves(got), jax.tree_util.tree_leaves(want)))


def _net_case(name, seed=0):
    """(JAX bf16 output, JAX bf16 grads, port bf16 (y, grads), port f32
    (y, grads)) of sum(y * c) over a batch of 8, the LSTM from a random
    carry."""
    kw = NETS[name]
    js, tb = _specs("bfloat16", **kw)
    _, tf = _specs("float32", **kw)
    params = jnet.init_params(jax.random.PRNGKey(1), js)
    rng = np.random.RandomState(seed)
    x = np32(rng.randn(8, js.n_in))
    c = np32(rng.randn(8, js.total_out))
    carry = jax.tree_util.tree_map(
        lambda z: jnp.asarray(np32(rng.randn(*z.shape) * 0.5)),
        jnet.init_carry(js, (8,)))

    def loss(p):
        y, _ = jnet.apply_net(p, js, jnp.asarray(x), carry)
        return jnp.sum(y * jnp.asarray(c)), y

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)
    tcarry = convert.carry_from_numpy(jax.device_get(carry))
    out = []
    for spec in (tb, tf):
        tp = convert.params_from_jax(jax.device_get(params))
        y, _ = tnet.apply_net(tp, spec, tt(x), tcarry)
        torch.sum(y * tt(c)).backward()
        out.append((tn(y), tnet.tree_map(lambda p: p.grad, tp)))
    return np.asarray(want), jax.device_get(grads), out


@pytest.mark.parametrize("name", sorted(NETS))
def test_net_forward_and_gradients(monkeypatch, name):
    _s2d(monkeypatch, False)
    want, grads, ((y, g), (y32, g32)) = _net_case(name)
    np.testing.assert_allclose(y, want, **NET_TOL)
    assert_tree_close(g, grads, **NET_TOL)
    assert all(x.dtype == torch.float32 for x in tnet.tree_leaves(g))
    # the f32 path is told apart: its output and some gradient miss
    assert _misses(y32, want, NET_TOL)
    assert _tree_misses(g32, grads, NET_TOL)


def test_lstm_casts_only_its_output_layer(monkeypatch):
    """The recurrent cells stay f32: an LSTM net in bf16 equals the f32
    cells followed by the bf16 output product."""
    _s2d(monkeypatch, False)
    js, tb = _specs("bfloat16", **NETS["lstm"])
    _, tf = _specs("float32", **NETS["lstm"])
    tp = convert.params_from_jax(jax.device_get(
        jnet.init_params(jax.random.PRNGKey(1), js)))
    rng = np.random.RandomState(4)
    x = tt(rng.randn(8, js.n_in))
    carry = tnet.init_carry(tf, (8,))
    y, c_bf16 = tnet.apply_net(tp, tb, x, carry)
    body = dict(tp, out={"W": torch.eye(16), "b": torch.zeros(16)})
    h, c_f32 = tnet.apply_net(body, tnet.NetSpec(
        n_in=24, hidden=(16, 16), n_out=16, kind="LSTM"), x, carry)
    want = ((h.to(torch.bfloat16) @ tp["out"]["W"].to(torch.bfloat16))
            .float() + tp["out"]["b"])
    assert torch.equal(y, want)
    for a, b in zip(tnet.tree_leaves(c_bf16), tnet.tree_leaves(c_f32)):
        assert torch.equal(a, b)


def test_conv_s2d(monkeypatch):
    """The JAX package's default space-to-depth first layer sums in
    another order: held at its own test's 2e-2."""
    _s2d(monkeypatch, True)
    js, _ = _specs("bfloat16", **NETS["conv"])
    assert jnet._s2d_stride(js.conv[0])
    want, grads, ((y, g), _) = _net_case("conv")
    np.testing.assert_allclose(y, want, **S2D_TOL)
    assert_tree_close(g, grads, **S2D_TOL)


def test_population_forward(monkeypatch):
    """RACER-ES's batched forward over stacked members ([P, in, out]
    weights, a [P] param head) in bf16 is the JAX package's vmap of
    apply_net over the members."""
    js, ts = _specs("bfloat16", n_in=5, hidden=(16, 16), n_out=3,
                    n_param_out=1, param_init=(0.2,))
    P = 4
    members = [jnet.init_params(jax.random.PRNGKey(i), js) for i in range(P)]
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *members)
    x = np32(np.random.RandomState(5).randn(6, 5))
    want = jax.vmap(lambda p: jnet.apply_net(p, js, jnp.asarray(x))[0])(
        stacked)
    # the learner's layout: flat members unravelled with members=True
    tmembers = [convert.params_from_jax(jax.device_get(m)) for m in members]
    pop = torch.stack([ravel(m) for m in tmembers]).detach()
    tp = Unravel(tmembers[0])(pop, members=True)
    got, _ = tnet.apply_net(tp, ts, tt(x)[None])
    assert got.shape == (P, 6, 4)
    np.testing.assert_allclose(tn(got), np.asarray(want), **NET_TOL)
    _, tf = _specs("float32", n_in=5, hidden=(16, 16), n_out=3,
                   n_param_out=1, param_init=(0.2,))
    assert _misses(tn(tnet.apply_net(tp, tf, tt(x)[None])[0]),
                   np.asarray(want), NET_TOL)


def test_jit_skips_the_output_rounding(monkeypatch):
    """Under jax.jit, XLA's CPU compiler folds each contraction's upcast
    into it: the operands are rounded to bf16, the output is not. The
    port rounds it, as the JAX package computes op by op (the tests
    above) and as cuBLAS and cuDNN return a bf16 product. The jitted
    forward is the f32 product of bf16-rounded operands. Here it is
    1.28e-4 from the port's bf16 forward and 1.18e-4 from its f32 one:
    the outputs' rounding weighs as much as the operands'."""
    _s2d(monkeypatch, False)
    js, ts = _specs("bfloat16", **NETS["ffnn"])
    params = jnet.init_params(jax.random.PRNGKey(1), js)
    x = np32(np.random.RandomState(0).randn(8, js.n_in))
    jitted = np.asarray(jax.jit(lambda p: jnet.apply_net(
        p, js, jnp.asarray(x))[0])(params))
    eager = np.asarray(jnet.apply_net(params, js, jnp.asarray(x))[0])
    tp = convert.params_from_jax(jax.device_get(params))
    port = tn(tnet.apply_net(tp, ts, tt(x))[0])
    np.testing.assert_array_equal(port, eager)

    def bf(a):
        return a.to(torch.bfloat16).float()

    h = tt(x)
    for layer in tp["layers"]:
        h = tnet._ACTS[ts.act](bf(h) @ bf(layer["W"]) + layer["b"])
    unrounded = tn(bf(h) @ bf(tp["out"]["W"]) + tp["out"]["b"])
    np.testing.assert_allclose(jitted[:, :5], unrounded, rtol=1e-6,
                               atol=1e-7)
    assert _misses(port, jitted, NET_TOL)


def test_compute_dtype_is_checked():
    with pytest.raises(ValueError, match="compute_dtype"):
        tnet.NetSpec(n_in=3, compute_dtype="float16")


# ---------------------------------------------------------------------
# 4 pinned train steps in bf16

# name: (MDP kind, settings)
LEARNERS = {
    "vracer": ("continuous", dict(learner="VRACER")),
    "racer_gaussian": ("continuous", dict(learner="RACER")),
    "dqn_refer_retrace": ("discrete", dict(learner="DQN", clipImpWeight=4.0,
                                           returnsEstimator="retrace",
                                           targetDelay=1e-3)),
    **{name: ("image", d) for name, d in CONV_CASES.items()},
}


def _learner_setup(kind, d):
    """(JAX MDP, port MDP, the JAX replay for settings d)."""
    if kind == "image":
        jmdp, tmdp = _img_mdps()
        return jmdp, tmdp, _jax_replay_img(jmdp, JHP(**d).clipImpWeight)
    jmdp, tmdp = _mdp(kind == "discrete")
    return jmdp, tmdp, _jax_replay(jmdp, JHP(**d).clipImpWeight)


def _port_steps(tmdp, d, params, opt, rs, pinned):
    tl = tmake(tmdp, THP(**d))
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    for ep, t in pinned:
        tp, to, tr, tm = tl.train_step(
            tp, to, tr, sample_override=(tt(ep, torch.int32),
                                         tt(t, torch.int32)))
    return tl, tp, to, tr, tm


@pytest.mark.parametrize("name", sorted(LEARNERS))
def test_four_train_steps(monkeypatch, name):
    _s2d(monkeypatch, False)
    kind, extra = LEARNERS[name]
    d = dict(BASE, nnBf16=True, **extra)
    jmdp, tmdp, replay = _learner_setup(kind, d)
    jl = jmake(jmdp, JHP(**d))
    assert jl.spec.compute_dtype == "bfloat16"
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = jl.initialize_stats(replay)
    pinned = _pinned(rs, 2, 4)
    jp, jo, jr = params, opt, rs
    for ep, t in pinned:
        jp, jo, jr, jm = jl.train_step(
            jp, jo, jr, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(ep), jnp.asarray(t)))
    tl, tp, to, tr, tm = _port_steps(tmdp, d, params, opt, rs, pinned)
    assert tl.spec.compute_dtype == "bfloat16"
    assert_tree_close(tp, jax.device_get(jp), **PARAM_TOL_BF16)
    (ja, _), (ta, _) = _opt_parts(jo), _opt_parts(to)
    assert_tree_close(ta.m1, jax.device_get(ja.m1), **MOMENT_TOL_BF16)
    assert_tree_close(ta.m2, jax.device_get(ja.m2),
                      **dict(MOMENT_TOL, rtol=MOMENT_TOL_BF16["rtol"]))
    assert int(ta.step) == int(ja.step) == 4
    assert all(x.dtype == torch.float32 for x in tnet.tree_leaves(tp))
    assert_replay_close(jr, tr, fields=("rho", "kl", "advantage"),
                        **POLICY_TOL)
    assert_replay_close(jr, tr, fields=("far_count", "length", "ep_id"),
                        rtol=0, atol=0)
    assert sorted(tm) == sorted(jm)
    # the port in f32 from the same state misses the JAX bf16 params
    _, tp32, to32, _, _ = _port_steps(tmdp, dict(d, nnBf16=False), params,
                                      opt, rs, pinned)
    assert _tree_misses(tp32, jax.device_get(jp), PARAM_TOL_BF16)
    assert _tree_misses(_opt_parts(to32)[0].m1, jax.device_get(ja.m1),
                        MOMENT_TOL_BF16)


ES_BASE = dict(nnLayerSizes=[16, 16], batchSize=16, minTotObsNum=64,
               maxTotObsNum=400, ESpopSize=6, clipImpWeight=4,
               explNoise=0.447214, gamma=0.995, learnrate=0.001,
               epsAnneal=0, outWeightsPrefac=0.01, randSeed=0,
               learner="VRACER", nnBf16=True)
POP_TOL = dict(rtol=1e-5, atol=1e-6)
KL_TOL_BF16 = dict(rtol=1e-4, atol=1e-6)


def test_racer_es_four_train_steps():
    """V-RACER-ES (the VRACER_CMA recipe's learner), a population of 6:
    the JAX step draws its minibatch and normals inside, the port gets
    the same pinned."""
    jl = jmake(jc.MDP, JHP(**ES_BASE))
    assert type(jl).__name__ == "RacerES"
    assert jl.spec.compute_dtype == "bfloat16"
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = jl.initialize_stats(_jax_replay(jc.MDP, 4.0))
    n = params["pop"].shape[1]
    jp, jo, jr, draws = params, opt, rs, []
    for i in range(4):
        key = jax.random.PRNGKey(20 + i)
        k_samp, k_res = jax.random.split(key)
        ep, t = jrb.sample(k_samp, jr, ES_BASE["batchSize"],
                           jl.cfg.dataSamplingAlgo)
        z = jax.random.normal(k_res, (ES_BASE["ESpopSize"], n), jnp.float32)
        draws.append((tt(ep, torch.int32), tt(t, torch.int32), tt(z)))
        jp, jo, jr, jm = jl.train_step(jp, jo, jr, key)
    got = {}
    for bf16 in (True, False):
        tl = tmake(tc.MDP, THP(**dict(ES_BASE, nnBf16=bf16)))
        tp = convert.params_from_jax(jax.device_get(params))
        to = convert.opt_state_from_jax(jax.device_get(opt))
        tr = convert.replay_from_jax(jax_replay_views(rs))
        for ep, t, z in draws:
            tp, to, tr, tm = tl.train_step(tp, to, tr,
                                           sample_override=(ep, t), z=z)
        got[bf16] = (tl, tp, to, tr, tm)
    tl, tp, to, tr, tm = got[True]
    assert tl.spec.compute_dtype == "bfloat16"
    assert_tree_close(tp, jax.device_get(jp), **POP_TOL)
    for f in ("diag_cov", "path_cov", "noise"):
        np.testing.assert_allclose(tn(getattr(to, f)),
                                   np.asarray(getattr(jo, f)), err_msg=f,
                                   **POP_TOL)
    assert_replay_close(jr, tr, fields=("rho", "advantage"), **POLICY_TOL)
    assert_replay_close(jr, tr, fields=("kl",), **KL_TOL_BF16)
    assert_replay_close(jr, tr, fields=("delta", "value", "max_abs_error"),
                        **VALUE_TOL)
    for k in jm:
        tol = VALUE_TOL if k in ("avg_v", "rmse") else dict(rtol=1e-4,
                                                             atol=1e-6)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)
    # the port in f32: the members' forward differs (the population does
    # not: the update depends on the members' ranking only); KL shows it
    assert _misses(convert.replay_to_numpy(got[False][3])["kl"],
                   jax_replay_views(jr)["kl"], KL_TOL_BF16)


# ---------------------------------------------------------------------
# the learners that compute in f32 whatever nnBf16 says

def _f32_learner_trainer(name, bf16):
    from smarties_tpu_torch.envs import pendulum
    from smarties_tpu_torch.runtime.trainer import Trainer
    small = dict(nnLayerSizes=[16], batchSize=16, minTotObsNum=128,
                 maxTotObsNum=512, randSeed=0, nnBf16=bf16)
    env, extra = {
        "naf": (tc, dict(learner="NAF")),
        "dpg": (pendulum, dict(learner="DPG", encoderLayerSizes=[16])),
        "mixedpg": (tc, dict(learner="MixedPG")),
        "ppo": (tc, dict(learner="PPO", encoderLayerSizes=[16],
                         maxTotObsNum=128, obsPerStep=4.0)),
        "acer": (pendulum, dict(learner="ACER", encoderLayerSizes=[16])),
    }[name]
    return Trainer(env, env.MDP, THP(**dict(small, **extra)), n_envs=4,
                   n_slots=64, max_len=32, device="cpu")


@pytest.mark.parametrize("name", ["acer", "dpg", "mixedpg", "naf", "ppo"])
def test_f32_learners_ignore_nnBf16(name):
    """As in the JAX package, these learners' nets stay f32: warmup and
    16 grad steps (PPO: one horizon cycle) give equal params either
    way."""
    out = []
    for bf16 in (False, True):
        tr = _f32_learner_trainer(name, bf16)
        assert tr.cfg.nnBf16 is bf16
        for spec in vars(tr.algo).values():
            if isinstance(spec, tnet.NetSpec):
                assert spec.compute_dtype == "float32"
        if not tr.on_policy:
            tr.warmup(chunk=16)
        tr.train_fused(16, log_every=10 ** 9)
        assert tr.n_grad_steps >= 16
        out.append(tnet.tree_leaves(tr.params))
    assert len(out[0]) == len(out[1]) > 0
    assert all(torch.equal(a, b) for a, b in zip(*out))

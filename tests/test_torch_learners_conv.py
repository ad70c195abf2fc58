"""Port parity: the conv learners and the prioritized samplers.

The conv cases (RACER-discrete and DQN with two conv layers over 12x12
images, 2 appended frames, a uint8 replay; the JAX side's own cases are
tests/test_conv_stack.py) run 4 pinned train steps against the JAX
package with its space-to-depth first layer (the default) and without
(SMT_NO_S2D=1). The conv gradients sum over positions and batch in
another order; the feed-forward tolerances of _torch_learner_cases.py
hold all the same (params rtol 1e-5 / atol 1e-7, moments rtol 1e-3). The
sampler cases run V-RACER under each prioritized sampler: every step's
(ep, t) is drawn by the port's sampler from the port's replay as the
steps before left it (injected uniforms) and pinned in both packages
through sample_override.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos.registry import make_learner as tmake
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_learner_cases import (B, BASE, CONV_CASES, IMG_K, MOMENT_TOL,
                                  PARAM_TOL, POLICY_TOL, RAW_VALUE_TOL,
                                  VALUE_TOL, _img_mdps, _jax_replay,
                                  _jax_replay_img, _mdp, _pinned,
                                  assert_replay_close, assert_tree_close,
                                  jax_replay_views, np32, tn, tt)

# ---------------------------------------------------------------------
# conv stack + appended frames on a uint8 replay


@pytest.mark.parametrize("s2d", [True, False], ids=["s2d", "no_s2d"])
@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_four_train_steps_conv(monkeypatch, name, s2d):
    if s2d:
        monkeypatch.delenv("SMT_NO_S2D", raising=False)
    else:
        monkeypatch.setenv("SMT_NO_S2D", "1")
    jmdp, tmdp = _img_mdps()
    d = dict(BASE, **CONV_CASES[name])
    jl, tl = jmake(jmdp, JHP(**d)), tmake(tmdp, THP(**d))
    assert type(tl).__name__ == type(jl).__name__
    assert len(tl.spec.conv) == 2 and tl.n_appended == IMG_K
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = jl.initialize_stats(_jax_replay_img(jmdp, JHP(**d).clipImpWeight))
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    assert tr.states_tm.dtype == torch.uint8
    # the port's own initialize_stats gives the JAX statistics (chunked)
    fresh = convert.replay_from_jax(jax_replay_views(
        _jax_replay_img(jmdp, JHP(**d).clipImpWeight)))
    assert_replay_close(rs, tl.initialize_stats(fresh),
                        fields=("state_mean", "state_scale", "rew_scale",
                                "qret"), rtol=1e-5, atol=1e-5)
    jp, jo, jr = params, opt, rs
    for ep, t in _pinned(rs, 2, 4):
        jp, jo, jr, jm = jl.train_step(
            jp, jo, jr, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(ep), jnp.asarray(t)))
        tp, to, tr, tm = tl.train_step(
            tp, to, tr, sample_override=(tt(ep, torch.int32),
                                         tt(t, torch.int32)))
    assert_tree_close(tp, jax.device_get(jp), **PARAM_TOL)
    assert_tree_close(to.m1, jax.device_get(jo.m1), **MOMENT_TOL)
    assert_tree_close(to.m2, jax.device_get(jo.m2), **MOMENT_TOL)
    assert int(to.step) == int(jo.step) == 4
    # the conv leaves moved
    p0 = jax.device_get(params)
    conv0 = (p0["net"] if "net" in p0 else p0)["conv"][0]["W"]
    conv1 = (tp["net"] if "net" in tp else tp)["conv"][0]["W"]
    assert np.abs(tn(conv1) - conv0).max() > 1e-5
    assert_replay_close(jr, tr, fields=("rho", "kl", "advantage"),
                        **POLICY_TOL)
    value_tol = VALUE_TOL if name.startswith("racer") else RAW_VALUE_TOL
    assert_replay_close(jr, tr, fields=("delta", "value", "v_trunc",
                                        "max_abs_error"), **value_tol)
    assert_replay_close(jr, tr, fields=("far_count", "length", "ep_id",
                                        "states"), rtol=0, atol=0)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        tol = value_tol if k in ("avg_v", "rmse") else dict(rtol=1e-4,
                                                             atol=1e-6)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_act_conv(name):
    """The acting head on stacked, standardized frames."""
    jmdp, tmdp = _img_mdps()
    d = dict(BASE, **CONV_CASES[name])
    jl, tl = jmake(jmdp, JHP(**d)), tmake(tmdp, THP(**d))
    params, _ = jl.init(jax.random.PRNGKey(0))
    tp = convert.params_from_jax(jax.device_get(params))
    obs = np32(np.random.RandomState(3).randn(8, jmdp.dim_net_input))
    jout = jl.make_act_fn(False)(params, jnp.asarray(obs),
                                 jax.random.PRNGKey(5), ())
    tout = tl.make_act_fn(False)(tp, tt(obs), None, ())
    for what, got, want, tol in zip(
            ("action", "mu", "value", "advantage"), tout[:4], jout[:4],
            (POLICY_TOL, POLICY_TOL, VALUE_TOL, VALUE_TOL)):
        np.testing.assert_allclose(tn(got), np.asarray(want), err_msg=what,
                                   **tol)


def test_frames_need_a_frame_gathering_learner():
    """Appended observations: RACER and DQN gather them; the learners
    whose JAX gather takes single frames refuse, as do recurrent nets."""
    _, tmdp = _img_mdps()
    with pytest.raises(ValueError, match="appended observations"):
        tmake(tmdp, THP(**dict(BASE, learner="PPO")))
    with pytest.raises(ValueError, match="BPTT"):
        tmake(tmdp, THP(**dict(BASE, learner="RACER", nnType="LSTM")))


# ---------------------------------------------------------------------
# the prioritized samplers under a learner

@pytest.mark.parametrize("algo", ["PERrank", "PERerr", "PERseq"])
def test_four_train_steps_sampler(algo):
    from smarties_tpu_torch.replay import buffer as trb
    jmdp, tmdp = _mdp(False)
    d = dict(BASE, learner="VRACER", dataSamplingAlgo=algo)
    jl, tl = jmake(jmdp, JHP(**d)), tmake(tmdp, THP(**d))
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = jl.initialize_stats(_jax_replay(jmdp, 4.0))
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    jp, jo, jr = params, opt, rs
    rng = np.random.RandomState(6)
    drawn = []
    for _ in range(4):
        u = tt(np32(rng.rand(2, B) if algo == "PERseq" else rng.rand(B)))
        ep, t = trb.sample(None, tr, B, algo, u=u)
        drawn.append((tn(ep), tn(t)))
        jp, jo, jr, jm = jl.train_step(
            jp, jo, jr, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(tn(ep)), jnp.asarray(tn(t))))
        tp, to, tr, tm = tl.train_step(tp, to, tr,
                                       sample_override=(ep, t))
    # later draws follow the TD errors the earlier steps wrote
    assert not all((drawn[0][0] == e).all() for e, _ in drawn[1:])
    assert_tree_close(tp, jax.device_get(jp), **PARAM_TOL)
    assert_replay_close(jr, tr, fields=("rho", "kl"), **POLICY_TOL)
    assert_replay_close(jr, tr, fields=("delta", "value"), **VALUE_TOL)
    # the same sampler inside the step, from a generator
    g = torch.Generator().manual_seed(0)
    tp, to, tr, tm = tl.train_step(tp, to, tr, gen=g)
    assert all(torch.isfinite(x).all() for x in tree_leaves(tp))
    assert torch.isfinite(tm["rmse"])


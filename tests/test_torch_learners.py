"""Port parity: the off-policy learners beyond V-RACER, and every
off-policy learner with a recurrent net.

Ten feed-forward configurations of RACER (Gaussian and discrete
advantage), DQN, NAF, DPG and MixedPG, and ten recurrent ones (BPTT
window 8 over episodes of 3..20 steps, so windows start before, at and
after the episode start): V-RACER with LSTM, GRU and RNN layers, RACER
Gaussian and discrete with an LSTM, DQN with an LSTM (Retrace-free with
a target net, and ReF-ER), NAF with a GRU, DPG with an LSTM encoder
(Retrace and 1-step with the target nets). For each, the JAX package
builds the learner, its
params and optimiser state and a replay of synthetic episodes shaped like
the cart-pole's (continuous, or the two-label discrete variant), and
initialises the replay's statistics and returns; everything goes through
smarties_tpu_torch.models.convert into the port. Both frameworks then
take 4 train steps on the same pinned (ep, t) samples (half of them just
before a truncation, so the V(s_T) refresh runs) and the params, target
params, optimiser state, metrics and replay write-backs are compared.
The act functions are held against the JAX ones with train=False, and
with train=True on the JAX draw injected into the port (the clipped
normals through `noise`, the categorical draw through the uniform at the
middle of the chosen option's CDF interval).

Tolerances are those of test_torch_vracer.py: params rtol 1e-5 / atol
1e-7, optimiser moments (and MixedPG's EMA factors) rtol 1e-3, policy
quantities rtol 1e-4 / atol 1e-5, RACER's values (with the avg_v and
rmse metrics) atol 2e-3 (its V passes through scale_net2v, which cancels
two terms near 5100), other metrics rtol 1e-4 / atol 1e-6. The other
learners' values are raw net outputs: rtol 1e-4 / atol 1e-6 there, which
also shows a value read from the post-step weights of the in-place Adam
step (it moves V by ~1e-5). Far counts and step counters are exact. The
recurrent cases keep these tolerances but for the optimiser moments, rtol
5e-3: their gradient is summed back through 8 window steps, and a
first-moment element that nearly cancels (1 of 80 here, |m1| ~ 6e-6
beside neighbours of 2e-4) shows the other summation order at 1.6e-3.

The conv cases (RACER-discrete and DQN with two conv layers over 12x12
images, 2 appended frames, a uint8 replay; the JAX side's own cases are
tests/test_conv_stack.py) run the same 4 pinned steps against the JAX
package with its space-to-depth first layer (the default) and without
(SMT_NO_S2D=1). The conv gradients sum over positions and batch in
another order; the feed-forward tolerances above hold all the same
(params rtol 1e-5 / atol 1e-7, moments rtol 1e-3). The sampler cases run
V-RACER
under each prioritized sampler: every step's (ep, t) is drawn by the
port's sampler from the port's replay as the steps before left it
(injected uniforms) and pinned in both packages through sample_override.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.envs import cartpole as jc
from smarties_tpu.ops import continuous_policy as jcp
from smarties_tpu.replay import buffer as jrb
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos.registry import make_learner as tmake
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, np32, tn, tt)

E, L, B = 24, 20, 32
BASE = dict(nnLayerSizes=[16, 16], batchSize=B, minTotObsNum=64,
            maxTotObsNum=400, randSeed=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
MOMENT_TOL = dict(rtol=1e-3, atol=1e-9)
MOMENT_TOL_RNN = dict(rtol=5e-3, atol=1e-9)
POLICY_TOL = dict(rtol=1e-4, atol=1e-5)
VALUE_TOL = dict(rtol=1e-4, atol=2e-3)
# values of the learners without scale_net2v (DQN, NAF, DPG, MixedPG):
# tight enough to see one post-step weight read (an Adam step moves V by
# ~1e-5 here)
RAW_VALUE_TOL = dict(rtol=1e-4, atol=1e-6)

# name: (discrete MDP?, settings)
CASES = {
    "racer_gaussian": (False, dict(learner="RACER")),
    "racer_discrete": (True, dict(learner="RACER")),
    "dqn_boltzmann_1step": (True, dict(learner="DQN", clipImpWeight=0.0,
                                       targetDelay=2)),
    "dqn_refer_retrace": (True, dict(learner="DQN", clipImpWeight=4.0,
                                     returnsEstimator="retrace",
                                     targetDelay=1e-3)),
    "dqn_eps_greedy": (True, dict(learner="DQN", dqnEpsGreedy=True,
                                  explNoise=0.1, clipImpWeight=0.0,
                                  targetDelay=0.01)),
    "naf": (False, dict(learner="NAF", returnsEstimator="retrace",
                        targetDelay=1e-3)),
    "naf_gaussian": (False, dict(learner="NAF", nafAdvGaussian=True,
                                 clipImpWeight=0.0, targetDelay=0.01)),
    "dpg_retrace": (False, dict(learner="DPG", returnsEstimator="retrace",
                                encoderLayerSizes=[16], targetDelay=1e-3)),
    "dpg_1step_ou": (False, dict(learner="DPG", clipImpWeight=0.0,
                                 encoderLayerSizes=[16], targetDelay=0.01)),
    "mixedpg": (False, dict(learner="MixedPG")),
    # recurrent nets (the matrix of tests/test_all_algos.py)
    "vracer_lstm": (False, dict(learner="VRACER", nnType="LSTM",
                                nnBPTTseq=8)),
    "vracer_gru": (False, dict(learner="VRACER", nnType="GRU",
                               nnBPTTseq=8)),
    "vracer_rnn": (False, dict(learner="VRACER", nnType="RNN",
                               nnBPTTseq=8)),
    "racer_gaussian_lstm": (False, dict(learner="RACER", nnType="LSTM",
                                        nnBPTTseq=8)),
    "racer_discrete_lstm": (True, dict(learner="RACER", nnType="LSTM",
                                       nnBPTTseq=8)),
    "dqn_lstm": (True, dict(learner="DQN", clipImpWeight=4.0,
                            nnType="LSTM", nnBPTTseq=8)),
    "dqn_lstm_1step_target": (True, dict(learner="DQN", clipImpWeight=0.0,
                                         returnsEstimator="none",
                                         targetDelay=2, nnType="LSTM",
                                         nnBPTTseq=8)),
    "naf_gru": (False, dict(learner="NAF", returnsEstimator="retrace",
                            targetDelay=1e-3, nnType="GRU", nnBPTTseq=8)),
    "dpg_lstm": (False, dict(learner="DPG", returnsEstimator="retrace",
                             targetDelay=1e-3, nnType="LSTM", nnBPTTseq=8)),
    "dpg_lstm_1step_target": (False, dict(learner="DPG",
                                          returnsEstimator="none",
                                          targetDelay=0.01, nnType="LSTM",
                                          nnBPTTseq=8)),
}


def _mdp(discrete):
    return (jc.discrete.MDP, tc.discrete.MDP) if discrete else (jc.MDP,
                                                                tc.MDP)


def _jax_replay(jmdp, clip):
    """E slots of synthetic episodes (lengths 3..L, four full ones, half
    terminal), committed by the JAX package."""
    rng = np.random.RandomState(0)
    V, L1 = E, L + 1
    lens = rng.randint(3, L + 1, V).astype(np.int32)
    lens[:4] = L
    terminal = rng.rand(V) > 0.5
    rew = np.zeros((V, L1), np.float32)
    rho = np.zeros((V, L1), np.float32)
    for v, n in enumerate(lens):
        rew[v, 1:n + 1] = np32(rng.randn(n) + 1.0)
        rho[v, :n] = 1.0
    if jmdp.is_discrete:
        n_opt = jmdp.max_action_label
        acts = np32(rng.randint(0, n_opt, (V, L1, 1)))
        p = np32(0.2 + rng.rand(V, L1, n_opt))
        mus = p / p.sum(-1, keepdims=True)
    else:
        acts = np32(rng.randn(V, L1, 1))
        mus = np.concatenate([np32(rng.randn(V, L1, 1) * 0.5),
                              np32(0.3 + np.abs(rng.randn(V, L1, 1)) * 0.2)],
                             -1)
    rs = jrb.init_replay(E, L, 5, 1, jmdp.dim_policy, clip,
                         mu_init=jrb.safe_mu(jmdp))
    return jrb.commit_episodes(
        rs, jnp.asarray(np32(rng.randn(V, L1, 5) * 0.5)), jnp.asarray(acts),
        jnp.asarray(mus), jnp.asarray(rew),
        jnp.asarray(np32(rng.randn(V, L1))), jnp.zeros((V, L1)),
        jnp.zeros((V, L1)), jnp.asarray(rho), jnp.asarray(lens),
        jnp.asarray(terminal), jnp.ones(V, bool), BASE["maxTotObsNum"],
        "oldest")


def _pinned(rs, seed, n_steps):
    """Distinct (ep, t) pairs per step; half the batch at t = T-1."""
    rng = np.random.RandomState(seed)
    lens = np.asarray(rs.length)
    valid = np.nonzero(np.asarray(rs.ep_id) >= 0)[0]
    out = []
    for _ in range(n_steps):
        pairs = {(int(e), int(lens[e]) - 1)
                 for e in rng.choice(valid, B // 2, replace=False)}
        while len(pairs) < B:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, lens[e]))))
        out.append(tuple(np.asarray(x, np.int32) for x in zip(*sorted(pairs))))
    return out


def _setup(name, replay=True):
    """Both learners, the JAX params and optimiser state, and (unless
    `replay` is False: the act tests need none) the initialised replay."""
    discrete, extra = CASES[name]
    jmdp, tmdp = _mdp(discrete)
    d = dict(BASE, **extra)
    jl, tl = jmake(jmdp, JHP(**d)), tmake(tmdp, THP(**d))
    assert type(tl).__name__ == type(jl).__name__
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = (jl.initialize_stats(_jax_replay(jmdp, JHP(**d).clipImpWeight))
          if replay else None)
    return jl, tl, params, opt, rs


def _opt_parts(opt):
    """(Adam state, extra EMA fields or {}) of either optimiser state."""
    if hasattr(opt, "adam"):
        return opt.adam, {"dpg_factor": opt.dpg_factor,
                          "err_q_factor": opt.err_q_factor}
    return opt, {}


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_train_steps(name):
    jl, tl, params, opt, rs = _setup(name)
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    jp, jo, jr = params, opt, rs
    for ep, t in _pinned(rs, 2, 4):
        jp, jo, jr, jm = jl.train_step(
            jp, jo, jr, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(ep), jnp.asarray(t)))
        tp, to, tr, tm = tl.train_step(
            tp, to, tr, sample_override=(tt(ep, torch.int32),
                                         tt(t, torch.int32)))
    assert_tree_close(tp, jax.device_get(jp), **PARAM_TOL)
    (ja, jx), (ta, tx) = _opt_parts(jo), _opt_parts(to)
    moment_tol = MOMENT_TOL if jl.cfg.nnType == "FFNN" else MOMENT_TOL_RNN
    assert_tree_close(ta.m1, jax.device_get(ja.m1), **moment_tol)
    assert_tree_close(ta.m2, jax.device_get(ja.m2), **moment_tol)
    assert int(ta.step) == int(ja.step) == 4
    np.testing.assert_allclose(float(ta.beta_t_1), float(ja.beta_t_1),
                               rtol=1e-6)
    assert_tree_close(tx, jax.device_get(jx), **MOMENT_TOL)
    assert_replay_close(jr, tr, fields=("rho", "kl", "advantage"),
                        **POLICY_TOL)
    value_tol = (VALUE_TOL if name.startswith(("racer", "vracer"))
                 else RAW_VALUE_TOL)
    assert_replay_close(jr, tr, fields=("delta", "value", "v_trunc",
                                        "max_abs_error"), **value_tol)
    assert_replay_close(jr, tr, fields=("far_count", "length", "ep_id"),
                        rtol=0, atol=0)
    assert_replay_close(jr, tr, fields=("beta", "alpha", "cmax_ret"),
                        rtol=1e-5, atol=1e-7)
    # V(s_T) was refreshed for the truncated slots that were sampled
    assert (tn(tr.v_trunc) != np.asarray(rs.v_trunc)).any()
    assert sorted(tm) == sorted(jm)
    for k in jm:
        tol = value_tol if k in ("avg_v", "rmse") else dict(rtol=1e-4,
                                                             atol=1e-6)
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   **tol)
    if isinstance(tp, dict) and "tgt" in tp:
        assert not any(x.requires_grad for x in tree_leaves(tp["tgt"]))


def _jax_noise(jl, key, out):
    """The draw JAX's act made with `key`, as the port's `noise`: the
    clipped normals, or a uniform inside the chosen option's interval."""
    a, mu = out[0], np.asarray(out[1])
    if not jl.mdp.is_discrete:
        return tt(jcp.clipped_normal(key, np.asarray(a).shape))
    o = np.asarray(a)[:, 0].astype(int)
    c = np.cumsum(mu, -1)
    p_o = np.take_along_axis(mu, o[:, None], -1)[:, 0]
    return tt((np.take_along_axis(c, o[:, None], -1)[:, 0] - p_o / 2)
              / c[:, -1])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_act(name, train):
    jl, tl, params, _, _ = _setup(name, replay=False)
    tp = convert.params_from_jax(jax.device_get(params))
    rng = np.random.RandomState(3)
    n = 16
    obs = np32(rng.randn(n, 5))
    # a random acting carry in the learner's own nesting: the OU state,
    # the net's recurrent state, (h, c) pairs for LSTM layers
    assert hasattr(tl, "init_rnn") == hasattr(jl, "init_rnn")
    zero = jax.device_get(jl.init_rnn(n)) if hasattr(jl, "init_rnn") else ()
    if zero:
        assert_tree_close(tl.init_rnn(n), zero, rtol=0, atol=0)
    carry = jax.tree_util.tree_map(
        lambda x: np32(rng.randn(*x.shape) * 0.5), zero)
    jrnn = jax.tree_util.tree_map(jnp.asarray, carry)
    trnn = convert.carry_from_numpy(carry)
    key = jax.random.PRNGKey(5)
    jout = jl.make_act_fn(train)(params, jnp.asarray(obs), key, jrnn)
    noise = _jax_noise(jl, key, jout) if train else None
    tout = tl.make_act_fn(train)(tp, tt(obs), None, trnn, noise=noise)
    for what, got, want, tol in zip(
            ("action", "mu", "value", "advantage"), tout[:4], jout[:4],
            (POLICY_TOL, POLICY_TOL, VALUE_TOL, VALUE_TOL)):
        np.testing.assert_allclose(tn(got), np.asarray(want), err_msg=what,
                                   **tol)
    assert_tree_close(tout[4], jax.device_get(jout[4]), **POLICY_TOL)
    assert_tree_close(convert.carry_from_numpy(
        convert.carry_to_numpy(tout[4])), convert.carry_to_numpy(tout[4]),
        rtol=0, atol=0)


def test_optimiser_state_round_trip():
    """MixedPG's optimiser state and DQN's {"net", "tgt"} params cross
    both ways."""
    jl, _, params, opt, _ = _setup("mixedpg")
    to = convert.opt_state_from_jax(jax.device_get(opt))
    back = convert.opt_state_to_numpy(to)
    assert sorted(back) == ["adam", "dpg_factor", "err_q_factor"]
    again = convert.opt_state_from_jax(back)
    assert_tree_close(again.adam.m1, back["adam"]["m1"], rtol=0, atol=0)
    assert int(again.step) == int(opt.adam.step)
    _, _, dparams, _, _ = _setup("dqn_refer_retrace")
    tp = convert.params_from_jax(jax.device_get(dparams))
    assert all(x.requires_grad for x in tree_leaves(tp["net"]))
    assert not any(x.requires_grad for x in tree_leaves(tp["tgt"]))
    assert_tree_close(tp, convert.params_to_jax(tp), rtol=0, atol=0)


# ---------------------------------------------------------------------
# conv stack + appended frames on a uint8 replay

IMG_W, IMG_K = 12, 2
IMG_CONV = ((IMG_W, IMG_W, IMG_K + 1, 4, 4, 2), (5, 5, 4, 8, 3, 2))
CONV_CASES = {
    "racer_discrete_conv": dict(learner="RACER", nnLayerSizes=[16]),
    "dqn_conv_refer_retrace": dict(learner="DQN", nnLayerSizes=[16],
                                   clipImpWeight=4.0,
                                   returnsEstimator="retrace",
                                   targetDelay=1e-3),
}


def _img_mdps():
    from smarties_tpu.core.mdp import MDPSpec as JM
    from smarties_tpu_torch.core.mdp import MDPSpec as TM
    kw = dict(dim_state=IMG_W * IMG_W, dim_action=1, discrete_values=(3,),
              n_appended_obs=IMG_K, conv_layers=IMG_CONV)
    return JM(**kw), TM(**kw)


def _jax_replay_img(jmdp, clip):
    """E slots of uint8 image episodes (lengths 1..L: some shorter than
    the frame window), committed by the JAX package."""
    rng = np.random.RandomState(0)
    V, L1 = E, L + 1
    lens = rng.randint(1, L + 1, V).astype(np.int32)
    lens[:4] = [1, 2, L, L]
    rew = np.zeros((V, L1), np.float32)
    rho = np.zeros((V, L1), np.float32)
    for v, n in enumerate(lens):
        rew[v, 1:n + 1] = np32(rng.randn(n) + 1.0)
        rho[v, :n] = 1.0
    p = np32(0.2 + rng.rand(V, L1, 3))
    # blocky images: a bright square on a dim background
    img = rng.randint(0, 40, (V, L1, IMG_W, IMG_W))
    for v in range(V):
        for t in range(L1):
            r, c = rng.randint(0, IMG_W - 3, 2)
            img[v, t, r:r + 3, c:c + 3] = 255
    rs = jrb.init_replay(E, L, IMG_W * IMG_W, 1, 3, clip,
                         state_dtype=jnp.uint8, mu_init=jrb.safe_mu(jmdp))
    return jrb.commit_episodes(
        rs, jnp.asarray(img.reshape(V, L1, -1).astype(np.uint8)),
        jnp.asarray(np32(rng.randint(0, 3, (V, L1, 1)))),
        jnp.asarray(p / p.sum(-1, keepdims=True)), jnp.asarray(rew),
        jnp.asarray(np32(rng.randn(V, L1))), jnp.zeros((V, L1)),
        jnp.zeros((V, L1)), jnp.asarray(rho), jnp.asarray(lens),
        jnp.asarray(rng.rand(V) > 0.5), jnp.ones(V, bool),
        BASE["maxTotObsNum"], "oldest")


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

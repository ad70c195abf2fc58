"""Port parity: on-policy PPO and the trainer's horizon cycle.

The JAX package builds the learner, its params, its PPOOptState and a
replay of synthetic episodes with acting-time values (continuous
cart-pole, or the two-label discrete variant), and initialize_stats fills
the GAE returns; everything crosses through smarties_tpu_torch.models.
convert. Both frameworks take 4 train steps on the same pinned (ep, t)
samples, for {continuous, discrete} x {default, ppoStandard}, and for
LSTM and GRU encoders (BPTT window 8). Compared: params (rtol 1e-5 / atol
1e-7), Adam moments (rtol 1e-3; 5e-3 for the recurrent encoders, as in
_torch_learner_cases.py), the shared step and beta powers, penal_coef and
dkl_target (rtol 1e-6), the written-back rho / kl / delta / value /
advantage (rtol 1e-4 / atol 1e-5), the far counts (exact) and the metrics
(rtol 1e-4 / atol 1e-6). The act functions are held against the JAX ones
with train False, and with train True on the JAX draw injected into the
port.

`log(max(mu[opt], 1e-38))`: 1e-38 is below f32's smallest normal. With a
stored probability of 0 the port gives log(1e-38) = -87.5 and a finite
rho of about 5e37 (PyTorch keeps subnormals on the CPU); XLA on the CPU
flushes the subnormal to 0 and gives log(0) = -inf, so rho = inf there.
The test asserts the port's value and accepts either from JAX. No
behaviour policy samples an option of probability 0, so the case does
not arise in training.

The trainer: one horizon of `_train_on_policy` at a small size makes
n_epochs * horizon / batch grad steps, one refresh, K1's plain branch is
called in GAE mode only (at every ingest and once in initialize_stats),
and the replay ends cleared; `train_fused` gives way to it; a PPO
checkpoint restores into a fresh trainer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.algos.ppo import PPO, PPOOptState
from smarties_tpu_torch.algos.registry import make_learner as tmake
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import retrace_kernel as rk
from smarties_tpu_torch.runtime.trainer import Trainer, _plain
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, np32, tn, tt)
from _torch_learner_cases import (BASE, MOMENT_TOL, MOMENT_TOL_RNN,
                                  PARAM_TOL, POLICY_TOL, _jax_noise,
                                  _jax_replay, _mdp, _pinned)

PPO_BASE = dict(BASE, learner="PPO", clipImpWeight=0.2,
                encoderLayerSizes=[16], nnLayerSizes=[16], gamma=0.995,
                klDivConstraint=0.01, obsPerStep=6.4, epsAnneal=0.0)
PPO_BASE["lambda"] = 0.97
# name: (discrete MDP?, settings)
CASES = {
    "continuous": (False, {}),
    "continuous_standard": (False, dict(ppoStandard=True)),
    "discrete": (True, {}),
    "discrete_standard": (True, dict(ppoStandard=True)),
    "continuous_no_encoder": (False, dict(encoderLayerSizes=[0])),
    "continuous_lstm": (False, dict(nnType="LSTM", nnBPTTseq=8)),
    "discrete_gru_standard": (True, dict(nnType="GRU", nnBPTTseq=8,
                                         encoderLayerSizes=[0],
                                         ppoStandard=True)),
}


def _setup(name, replay=True):
    discrete, extra = CASES[name]
    jmdp, tmdp = _mdp(discrete)
    d = dict(PPO_BASE, **extra)
    jl, tl = jmake(jmdp, JHP.from_dict(d)), tmake(tmdp, THP.from_dict(d))
    assert type(tl) is PPO and tl.on_policy and tl.returns_mode == "GAE"
    assert (tl.n_horizon, tl.n_epochs) == (jl.n_horizon, jl.n_epochs)
    params, opt = jl.init(jax.random.PRNGKey(0))
    rs = jl.initialize_stats(_jax_replay(jmdp, 0.2)) if replay else None
    return jl, tl, params, opt, rs


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_train_steps(name):
    jl, tl, params, opt, rs = _setup(name)
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    assert isinstance(to, PPOOptState)
    # spread the penalty state so that both updates move it
    to = to._replace(dkl_target=torch.tensor(0.05))
    opt = opt._replace(dkl_target=jnp.float32(0.05))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    assert_replay_close(rs, tr, fields=("qret",), rtol=0, atol=0)
    jp, jo, jr = params, opt, rs
    for ep, t in _pinned(rs, 2, 4):
        jp, jo, jr, jm = jl.train_step(
            jp, jo, jr, jax.random.PRNGKey(0),
            sample_override=(jnp.asarray(ep), jnp.asarray(t)))
        tp, to, tr, tm = tl.train_step(
            tp, to, tr, sample_override=(tt(ep, torch.int32),
                                         tt(t, torch.int32)))
    assert sorted(tp) == sorted(jp)
    assert_tree_close(tp, jax.device_get(jp), **PARAM_TOL)
    moment_tol = MOMENT_TOL if jl.cfg.nnType == "FFNN" else MOMENT_TOL_RNN
    assert_tree_close(to.adam.m1, jax.device_get(jo.adam.m1), **moment_tol)
    assert_tree_close(to.adam.m2, jax.device_get(jo.adam.m2), **moment_tol)
    assert int(to.step) == int(jo.step) == 4
    for k in ("beta_t_1", "beta_t_2"):
        np.testing.assert_allclose(float(getattr(to.adam, k)),
                                   float(getattr(jo.adam, k)), rtol=1e-6)
    for k in ("penal_coef", "dkl_target"):
        got, want = getattr(to, k), getattr(jo, k)
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6,
                                   err_msg=k)
    assert float(to.penal_coef) != 1.0 and float(to.dkl_target) != 0.05
    assert_replay_close(jr, tr, fields=("rho", "kl", "delta", "value",
                                        "advantage"), **POLICY_TOL)
    assert_replay_close(jr, tr, fields=("far_count", "length", "ep_id",
                                        "v_trunc", "qret"), rtol=0, atol=0)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), err_msg=k,
                                   rtol=1e-4, atol=1e-6)


def test_round_trip_of_the_optimiser_state():
    jl, tl, params, opt, _ = _setup("continuous")
    to = convert.opt_state_from_jax(jax.device_get(opt))
    back = convert.opt_state_to_numpy(to)
    assert sorted(back) == ["adam", "dkl_target", "penal_coef"]
    again = convert.opt_state_from_jax(back)
    assert isinstance(again, PPOOptState)
    assert float(again.dkl_target) == np.float32(0.01)
    assert float(again.penal_coef) == 1.0 and int(again.step) == 0
    tp, to2 = tl.init(torch.Generator().manual_seed(0))
    assert sorted(tp) == ["actor", "critic", "enc"]
    shapes = lambda t: jax.tree_util.tree_map(np.shape, t)
    assert shapes(convert.params_to_jax(tp)) == shapes(jax.device_get(params))
    assert float(to2.dkl_target) == np.float32(0.01)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["continuous", "discrete",
                                  "continuous_lstm"])
def test_act(name, train):
    jl, tl, params, _, _ = _setup(name, replay=False)
    tp = convert.params_from_jax(jax.device_get(params))
    rng = np.random.RandomState(3)
    n = 16
    obs = np32(rng.randn(n, 5))
    carry = jax.tree_util.tree_map(
        lambda x: np32(rng.randn(*x.shape) * 0.5), jl.init_rnn(n))
    assert_tree_close(tl.init_rnn(n), jax.device_get(jl.init_rnn(n)),
                      rtol=0, atol=0)
    key = jax.random.PRNGKey(5)
    jout = jl.make_act_fn(train)(params, jnp.asarray(obs), key,
                                 jax.tree_util.tree_map(jnp.asarray, carry))
    noise = _jax_noise(jl, key, jout) if train else None
    tout = tl.make_act_fn(train)(tp, tt(obs), None,
                                 convert.carry_from_numpy(carry), noise=noise)
    for what, got, want in zip(("action", "mu", "value", "advantage"),
                               tout[:4], jout[:4]):
        np.testing.assert_allclose(tn(got), np.asarray(want), err_msg=what,
                                   **POLICY_TOL)
    assert not tn(tout[3]).any()
    assert_tree_close(tout[4], jax.device_get(jout[4]), **POLICY_TOL)
    if train:
        greedy = tl.make_act_fn(False)(tp, tt(obs), None,
                                       convert.carry_from_numpy(carry))
        assert (tn(greedy[0]) != tn(tout[0])).any()


def test_stored_probability_of_zero():
    """mu[opt] == 0: log(max(0, 1e-38)) on both sides."""
    jl, tl, params, opt, rs = _setup("discrete")
    (ep, t), = _pinned(rs, 2, 1)
    mus = np.array(rs.mus)
    opt0 = int(np.asarray(rs.actions)[ep[0], t[0], 0])
    mus[ep[0], t[0]] = np.eye(2, dtype=np.float32)[1 - opt0]
    rs = rs._replace(mus=jnp.asarray(mus))
    tr = convert.replay_from_jax(jax_replay_views(rs))
    tp = convert.params_from_jax(jax.device_get(params))
    to = convert.opt_state_from_jax(jax.device_get(opt))
    _, _, jr, _ = jl.train_step(
        params, opt, rs, jax.random.PRNGKey(0),
        sample_override=(jnp.asarray(ep), jnp.asarray(t)))
    tp, to, tr, tm = tl.train_step(
        tp, to, tr, sample_override=(tt(ep, torch.int32),
                                     tt(t, torch.int32)))
    got = float(tr.rho[ep[0], t[0]])
    want = float(np.asarray(jr.rho)[ep[0], t[0]])
    # the port: pi / 1e-38 ~ 5e37, finite. JAX on the CPU flushes the
    # subnormal and gives inf (the same value were it kept)
    assert np.isfinite(got) and got > 1e37
    assert want == np.inf or np.isclose(want, got, rtol=1e-4), (got, want)
    # the gain of that row is clipped to 0 on both sides: params stay finite
    assert all(torch.isfinite(x).all() for x in tree_leaves(tp))
    others = np.ones(len(ep), bool)
    others[0] = False
    np.testing.assert_allclose(
        tn(tr.rho)[ep[others], t[others]],
        np.asarray(jr.rho)[ep[others], t[others]], **POLICY_TOL)


# ---------------- the horizon cycle ----------------

def _ppo_trainer(tmp_path=None, seed=0, **extra):
    d = dict(PPO_BASE, minTotObsNum=128, maxTotObsNum=128, batchSize=16,
             obsPerStep=4.0, randSeed=seed, **extra)
    return Trainer(tc, tc.MDP, THP.from_dict(d), n_envs=4, n_slots=64,
                   max_len=32, device="cpu",
                   run_dir=str(tmp_path) if tmp_path else None)


def test_train_on_policy_one_horizon(monkeypatch):
    tr = _ppo_trainer()
    assert tr.on_policy and not tr.algo_is_recurrent
    horizon, batch = 128, 16
    assert (tr.algo.n_horizon, tr.algo.n_epochs) == (horizon, 4)
    modes, n_refresh, stored, chunks = [], [], [], []
    plain = rk.retrace_sweep_plain_

    def counted(*a):
        modes.append(a[13])
        return plain(*a)

    monkeypatch.setattr(rk, "retrace_sweep_plain_", counted)
    refresh, train_chunk = tr._refresh, tr._train_chunk

    def counting_refresh(rs, n):
        n_refresh.append(n)
        stored.append(int(rs.n_stored_steps()))
        return refresh(rs, n)

    def counting_chunk(n):
        chunks.append(n)
        return train_chunk(n)

    tr._refresh, tr._train_chunk = counting_refresh, counting_chunk
    cuda_lib.reset_launches()
    tr.train_fused(1)      # gives way to train -> one whole horizon cycle
    n_updates = 4 * horizon // batch
    assert tr.n_grad_steps == n_updates == 32
    assert chunks == [horizon // batch] * 4
    assert n_refresh == [float(n_updates)]
    assert horizon <= stored[0] <= 4 * horizon
    assert tr._initialized
    # cleared: nothing stored, nothing to sample, counters kept
    rs = tr.replay
    assert int(rs.n_stored_steps()) == 0 and int(rs.n_stored_eps()) == 0
    assert int(rs.samp_csum[-1]) == 0 and int(rs.n_seen_steps) >= horizon
    # K1's plain branch: GAE at every ingest and in initialize_stats, no
    # kernel launch on the CPU
    n_rolls = tr.n_env_steps // (tr.n_envs * 4)
    assert modes == ["GAE"] * (n_rolls + 1)
    assert sum(rk.launches.values()) == 0
    assert all(torch.isfinite(x).all() for x in tree_leaves(tr.params))
    assert all(torch.isfinite(m).all() for m in tr._last_metrics.values())
    # a second horizon starts from the cleared replay, without a new init
    tr.train(1)
    assert tr.n_grad_steps == 2 * n_updates and len(n_refresh) == 2
    assert modes.count("GAE") == len(modes) == tr.n_env_steps // 16 + 1


def test_ppo_checkpoint_restores(tmp_path):
    tr = _ppo_trainer(tmp_path, nnType="LSTM", nnBPTTseq=4)
    tr.train(1)
    tr._roll(3)
    path = str(tmp_path / "ck.pt")
    tr.save(path)
    fresh = _ppo_trainer(seed=9, nnType="LSTM", nnBPTTseq=4)
    fresh.restore(path)
    assert isinstance(fresh.opt_state, PPOOptState)
    for a, b in zip(tree_leaves(_plain(fresh.opt_state)),
                    tree_leaves(_plain(tr.opt_state)), strict=True):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(tr.params),
                    strict=True):
        assert torch.equal(a, b.detach())
    assert isinstance(fresh.carry.rnn[0], tuple)
    for a, b in zip(tree_leaves(fresh.carry.rnn), tree_leaves(tr.carry.rnn),
                    strict=True):
        assert torch.equal(a, b)
    before = convert.replay_to_numpy(tr.replay)
    after = convert.replay_to_numpy(fresh.replay)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert fresh.n_grad_steps == tr.n_grad_steps and fresh._initialized
    for x in (tr, fresh):
        x.train(1)
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(tr.params),
                    strict=True):
        assert torch.equal(a, b.detach())

"""Port parity: predator-prey (smarties_tpu_torch/envs/predator_prey.py
against smarties_tpu/envs/predator_prey.py) and the shared-learner
Trainer on it (the twin of tests/test_multiagent.py).

- The env: 250 steps at 16 envs (32 lanes) with random actions, the
  same start positions in both, every env truncating at step 200 and
  reset with the same pinned draw; per-env resets of a lane mask; the
  zero-sum reward. Positions wrap with `remainder` and the periodic
  displacement rounds half to even in both: observations and rewards
  rtol 1e-5 / atol 1e-5 (one f32 step, a norm of two terms), done,
  terminal and the step counters exactly.
- The Trainer: with bTrain=False (deterministic acting) and the JAX
  Trainer's params converted, both roll the same start positions to the
  common truncation at step 200 and commit every lane's episode; the
  committed replay after the at-ingest Retrace sweep agrees field by
  field (states and actions rtol 1e-4 / atol 1e-5 after 200 steps of
  the net and the env; values and returns atol 2e-3, one f32 ulp of the
  5100 that scale_net2v cancels, as in test_torch_slice.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from smarties_tpu.envs import predator_prey as jpp
from smarties_tpu.runtime.trainer import Trainer as JTrainer
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.envs import predator_prey as tpp
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.runtime.trainer import Trainer as TTrainer
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import assert_replay_close, np32, tn, tt

E = 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_state(u, step):
    return jpp.PPState(pred=jnp.asarray(u[:, :2]), prey=jnp.asarray(u[:, 2:]),
                       step=jnp.asarray(step, jnp.int32))


def test_constants_and_mdp():
    for k in ("N_AGENTS", "ARENA", "SPEED_PRED", "SPEED_PREY", "MAX_STEPS"):
        assert getattr(tpp, k) == getattr(jpp, k), k
    for k in ("dim_state", "dim_action", "bounded", "upper_action",
              "lower_action", "observable", "n_agents_per_env",
              "shared_noise"):
        assert getattr(tpp.MDP, k) == getattr(jpp.MDP, k), k
    # the env's descriptor leaves shared_noise off (only the
    # Communicator sets it)
    assert not tpp.MDP.shared_noise


def test_250_steps_with_pinned_resets():
    rng = np.random.RandomState(0)
    u = np32(rng.rand(E, 4))
    ts = tpp.init(None, 2 * E, u_new=tt(u))
    js = _jax_state(u, np.zeros(E))
    n_done = 0
    for k in range(250):
        np.testing.assert_allclose(tn(tpp.observe(ts)),
                                   np.asarray(jpp.observe(js)),
                                   err_msg=f"obs at step {k}", **TOL)
        a = np32(rng.uniform(-1, 1, (2 * E, 2)))
        js, jr, jd, jt = jpp.step(js, jnp.asarray(a))
        ts, tr_, td, tterm = tpp.step(ts, tt(a))
        np.testing.assert_allclose(tn(tr_), np.asarray(jr),
                                   err_msg=f"reward at step {k}", **TOL)
        np.testing.assert_array_equal(tn(td), np.asarray(jd))
        np.testing.assert_array_equal(tn(tterm), np.asarray(jt))
        np.testing.assert_array_equal(tn(ts.step), np.asarray(js.step))
        done = np.asarray(jd)
        n_done += int(done.sum())
        u_new = np32(rng.rand(E, 4))
        env_done = done.reshape(E, 2).any(1)
        js = _jax_state(
            np.where(env_done[:, None], u_new,
                     np.concatenate([np.asarray(js.pred),
                                     np.asarray(js.prey)], 1)),
            np.where(env_done, 0, np.asarray(js.step)))
        ts = tpp.reset_where(ts, tt(done, torch.bool), u_new=tt(u_new))
    # every lane truncated once, at step 200
    assert n_done == 2 * E
    assert int(tn(ts.step).max()) == 50


def test_reset_mask_is_per_env():
    """A lane's mask resets its whole env (both agents), as the JAX
    reset_where's `any` over the agent axis does."""
    rng = np.random.RandomState(1)
    u_old, u_new = np32(rng.rand(E, 4)), np32(rng.rand(E, 4))
    lanes = rng.rand(2 * E) > 0.7
    js = _jax_state(u_old, np.full(E, 9))
    jr = jpp.reset_where(js, jnp.asarray(lanes), jax.random.PRNGKey(0))
    ts = tpp.reset_where(tpp.init(None, 2 * E, u_new=tt(u_old))._replace(
        step=torch.full((E,), 9, dtype=torch.int32)), tt(lanes, torch.bool),
        u_new=tt(u_new))
    env = lanes.reshape(E, 2).any(1)
    np.testing.assert_array_equal(tn(ts.step), np.asarray(jr.step))
    np.testing.assert_array_equal(tn(ts.pred)[~env], np.asarray(jr.pred)[~env])
    np.testing.assert_array_equal(tn(ts.pred)[env], u_new[env, :2])
    np.testing.assert_array_equal(tn(ts.prey)[env], u_new[env, 2:])
    # the generator's draw lies in [0, 1)^2 like the JAX one
    g = tpp.init(torch.Generator().manual_seed(0), 8192)
    for x in (g.pred, g.prey):
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0
        assert abs(float(x.mean()) - 0.5) < 0.02


def test_rewards_are_zero_sum():
    """tests/test_multiagent.py::test_env_rewards_are_zero_sum, and the
    same for the port's step at the JAX start positions."""
    js = jpp.init(jax.random.PRNGKey(0), 8)
    u = np.concatenate([np.asarray(js.pred), np.asarray(js.prey)], 1)
    ts = tpp.init(None, 8, u_new=tt(u))
    a = np.full((8, 2), 0.5, np.float32)
    _, r, _, _ = tpp.step(ts, tt(a))
    r = tn(r).reshape(-1, 2)
    np.testing.assert_allclose(r[:, 0] + r[:, 1], 0.0, atol=1e-6)
    _, jr, _, _ = jpp.step(js, jnp.asarray(a))
    np.testing.assert_allclose(r.reshape(-1), np.asarray(jr), **TOL)


CFG = dict(minTotObsNum=1024, maxTotObsNum=8192, batchSize=64,
           nnLayerSizes=[32, 32], gamma=0.99)


def test_shared_learner_lanes_and_training():
    """tests/test_multiagent.py::test_lanes_and_training: both agents'
    lanes feed one learner through one replay."""
    tr = TTrainer(tpp, tpp.MDP, THP(**CFG), n_envs=16, n_slots=256,
                  max_len=tpp.MAX_STEPS, device="cpu")
    tr.warmup(chunk=32)
    tr.train(200, log_every=10 ** 9)
    assert tr.n_grad_steps >= 200
    rs = tr.replay
    assert int(rs.n_stored_eps()) > 0
    assert np.isfinite(float(rs.beta))
    # whole episodes of 200 steps, both agents of each env
    lens = tn(rs.length)[tn(rs.valid_slots())]
    assert (lens == tpp.MAX_STEPS).all()
    rets = tr.evaluate(8, max_steps=tpp.MAX_STEPS)
    np.testing.assert_allclose(rets.reshape(-1, 2).sum(1), 0.0, atol=1e-3)


def test_deterministic_rollout_to_truncation():
    """The JAX and the port's Trainer, deterministic acting, the same
    params and start positions: 201 sweeps commit every lane's episode
    at the common truncation; the replays agree after the ingest
    sweep."""
    cfg = dict(CFG, nnLayerSizes=[16, 16], bTrain=False)
    jt = JTrainer(jpp, jpp.MDP, JHP(**cfg), n_envs=16, n_slots=64,
                  max_len=jpp.MAX_STEPS)
    pt = TTrainer(tpp, tpp.MDP, THP(**cfg), n_envs=16, n_slots=64,
                  max_len=tpp.MAX_STEPS, device="cpu")
    params = convert.params_from_jax(jax.device_get(jt.params))
    js = jt.carry.env_state
    u = np.concatenate([np.asarray(js.pred), np.asarray(js.prey)], 1)
    pt.carry = pt.carry._replace(env_state=tpp.init(None, 16,
                                                    u_new=tt(u)))
    jc, jlogs = jt._rollout(jt.params, jt.carry, tpp.MAX_STEPS + 1)
    pc, plogs = pt._rollout(params, pt.carry, tpp.MAX_STEPS + 1)
    np.testing.assert_array_equal(tn(plogs[0]), np.asarray(jlogs[0]))
    assert np.asarray(jlogs[0])[tpp.MAX_STEPS - 1].all()
    # the returns up to the truncation (the last sweep starts episodes
    # from the frameworks' own reset draws)
    np.testing.assert_allclose(tn(plogs[2])[:tpp.MAX_STEPS],
                               np.asarray(jlogs[2])[:tpp.MAX_STEPS],
                               rtol=1e-4, atol=1e-4)
    jr = jt._fix_returns(jc.replay)
    pr = pt._fix_returns(pc.replay)
    assert int(pr.n_stored_eps()) == 16
    assert_replay_close(jr, pr, fields=("length", "ep_id", "terminal",
                                        "n_seen_steps", "n_seen_eps"),
                        rtol=0, atol=0)
    assert_replay_close(jr, pr, fields=("states", "actions", "mus", "rho",
                                        "rewards"), rtol=1e-4, atol=1e-5)
    assert_replay_close(jr, pr, fields=("value", "v_trunc", "qret"),
                        rtol=1e-4, atol=2e-3)

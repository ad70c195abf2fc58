"""Port parity and mechanics of the whole slice: V-RACER on cart-pole.

1. Learner path: the JAX Trainer's warmup fills a replay; its params,
   Adam state and replay are converted into the port. Both then run
   initialize_stats -> N train steps on pinned (ep, t) -> refresh, and
   every replay field, the params and the moments are compared.
2. Acting path: with bTrain=False (deterministic acting) both trainers
   roll the same start states with the same params, sweep by sweep,
   until the first lane finishes; every episode committed up to then
   (before any reset, whose draws differ between the frameworks) and its
   at-ingest Retrace estimate must agree.
3. The port's trainer alone at a small size: warmup -> train_fused ->
   train -> evaluate, the obsPerStep pacing of tests/test_fused.py, the
   cumulative_rewards.dat rows and a save/restore round trip.

Tolerances as in test_torch_vracer.py (values through scale_net2v:
atol 2e-3); the rollout's states pass through the net and RK4 for tens
of steps: rtol 1e-4 / atol 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from smarties_tpu.envs import cartpole as jc
from smarties_tpu.runtime.trainer import Trainer as JTrainer
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.runtime.trainer import Trainer as TTrainer
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, tn, tt)

N_ENVS, N_SLOTS, MAX_LEN = 16, 64, 64
CFG = dict(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
           nnLayerSizes=[16, 16], obsPerStep=1.0, randSeed=0)
VALUE_TOL = dict(rtol=1e-4, atol=2e-3)


def _jax_trainer(**kw):
    return JTrainer(jc, jc.MDP, JHP(**dict(CFG, **kw)), n_envs=N_ENVS,
                    n_slots=N_SLOTS, max_len=MAX_LEN)


def _port_trainer(run_dir=None, **kw):
    return TTrainer(tc, tc.MDP, THP(**dict(CFG, **kw)), n_envs=N_ENVS,
                    n_slots=N_SLOTS, max_len=MAX_LEN, device="cpu",
                    run_dir=run_dir)


def _pinned(rs, seed, n_steps, B):
    rng = np.random.RandomState(seed)
    lens = np.asarray(rs.length)
    valid = np.nonzero(np.asarray(rs.ep_id) >= 0)[0]
    out = []
    for _ in range(n_steps):
        pairs = set()
        while len(pairs) < B:
            e = int(rng.choice(valid))
            pairs.add((e, int(rng.randint(0, lens[e]))))
        out.append(tuple(np.asarray(x, np.int32) for x in zip(*sorted(pairs))))
    return out


def test_learner_path_after_jax_warmup():
    jt = _jax_trainer()
    jt.warmup(chunk=16)
    rs0 = jax.device_get(jt.replay)
    assert int(rs0.n_stored_steps()) >= CFG["minTotObsNum"]
    jl = jt.algo
    tt_ = _port_trainer()
    tl = tt_.algo
    tp = convert.params_from_jax(jax.device_get(jt.params))
    to = convert.adam_state_from_jax(jax.device_get(jt.opt_state))
    tr = convert.replay_from_jax(jax_replay_views(rs0))

    jp, jo, jr = jt.params, jt.opt_state, jl.initialize_stats(jt.replay)
    tr = tl.initialize_stats(tr)
    assert_replay_close(jr, tr, fields=("qret", "state_mean", "state_std",
                                        "rew_std"), rtol=1e-4, atol=1e-4)
    for ep, t in _pinned(jr, 1, 4, CFG["batchSize"]):
        jp, jo, jr, _ = jl.train_step(jp, jo, jr, jax.random.PRNGKey(0),
                                      sample_override=(jnp.asarray(ep),
                                                       jnp.asarray(t)))
        tp, to, tr, _ = tl.train_step(tp, to, tr, sample_override=(
            tt(ep, torch.int32), tt(t, torch.int32)))
    jr = jl.refresh(jr, 1000.0)
    tr = tl.refresh(tr, 1000.0)
    assert_tree_close(tp, jax.device_get(jp), rtol=1e-5, atol=1e-7)
    assert_tree_close(to.m1, jax.device_get(jo.m1), rtol=1e-3, atol=1e-9)
    assert_replay_close(jr, tr, fields=(
        "states", "rewards", "actions", "mus", "length", "ep_id",
        "terminal", "far_count", "qret_stale", "n_seen_eps"), rtol=0,
        atol=0)
    assert_replay_close(jr, tr, fields=("rho", "kl", "advantage", "beta",
                                        "cmax_ret", "rew_mean", "rew_std",
                                        "state_mean", "state_std"),
                        rtol=1e-4, atol=1e-5)
    assert_replay_close(jr, tr, fields=("qret", "delta", "value", "v_trunc",
                                        "max_abs_error"), **VALUE_TOL)


def test_deterministic_rollout_until_first_reset():
    jt = _jax_trainer(bTrain=False)
    pt = _port_trainer(bTrain=False)
    params = convert.params_from_jax(jax.device_get(jt.params))
    u0 = np.asarray(jt.carry.env_state.u)
    pt.carry = pt.carry._replace(env_state=tc.init(None, N_ENVS,
                                                   u_new=tt(u0)))
    jc_, pc_ = jt.carry, pt.carry
    for sweep in range(MAX_LEN):
        jc_, jlogs = jt._rollout(jt.params, jc_, 1)
        pc_, plogs = pt._rollout(params, pc_, 1)
        np.testing.assert_array_equal(tn(plogs[0]), np.asarray(jlogs[0]))
        if np.asarray(jlogs[0]).any():
            break
    assert 0 < sweep < MAX_LEN - 1
    assert int(pc_.replay.n_stored_eps()) > 0
    np.testing.assert_allclose(tn(plogs[2]), np.asarray(jlogs[2]))
    jr = jt._fix_returns(jc_.replay)
    pr = pt._fix_returns(pc_.replay)
    assert_replay_close(jr, pr, fields=("length", "ep_id", "terminal",
                                        "rewards", "n_seen_steps"),
                        rtol=0, atol=0)
    assert_replay_close(jr, pr, fields=("states", "actions", "mus", "rho"),
                        rtol=1e-4, atol=1e-5)
    assert_replay_close(jr, pr, fields=("value", "v_trunc", "qret"),
                        **VALUE_TOL)
    # the lanes still running hold the same in-progress episodes
    np.testing.assert_array_equal(tn(pc_.inprog.t), np.asarray(jc_.inprog.t))
    np.testing.assert_allclose(tn(pc_.inprog.states.transpose(0, 1)),
                               np.asarray(jc_.inprog.states), rtol=1e-4,
                               atol=1e-5)


def test_port_trainer_pacing_and_loops(tmp_path):
    """warmup -> train_fused -> train -> evaluate on the CPU, keeping the
    obsPerStep invariant as the JAX fused cycle does (test_fused.py)."""
    tr = _port_trainer(run_dir=str(tmp_path))
    tr.warmup(chunk=16)
    assert tr._initialized
    g0 = tr.n_grad_steps
    backlog0 = (tr.n_env_steps - tr.n_obs_b4_start) - g0
    tr.train_fused(2 * N_ENVS + backlog0, log_every=10 ** 9)
    assert tr.n_grad_steps >= g0 + 2 * N_ENVS
    n_loc = tr.n_env_steps - tr.n_obs_b4_start
    assert abs(n_loc - tr.n_grad_steps) <= tr.n_envs + backlog0
    assert n_loc >= tr.n_grad_steps * tr.cfg.obsPerStep - tr.n_envs
    g1 = tr.n_grad_steps
    tr.train(100, log_every=10 ** 9)
    assert tr.n_grad_steps >= g1 + 100
    assert n_loc <= tr.n_env_steps - tr.n_obs_b4_start
    for k, v in tr._last_metrics.items():
        assert torch.isfinite(v).all(), k
    rets = tr.evaluate(4, max_steps=100)
    assert rets.shape == (4,) and np.isfinite(rets).all()
    assert (rets >= 1).all() and (rets <= 100).all()
    # cumulative_rewards.dat: [grad-step, env-step, agent, length, return]
    tr._rew_file.flush()
    rows = np.loadtxt(tmp_path / "agent_00_rank00_cumulative_rewards.dat",
                      ndmin=2)
    assert rows.shape[1] == 5 and len(rows) == len(tr._ep_returns)
    assert (rows[:, 3] >= 1).all() and (rows[:, 2] < N_ENVS).all()
    np.testing.assert_allclose(rows[:, 4], rows[:, 3] - 1, atol=1)


def test_blind_warmup_deferred_logs_and_checkpoint(tmp_path):
    tr = _port_trainer()
    tr.log_flush_threshold = 10 ** 9
    tr.warmup(chunk=16, blind_sweeps=64)
    assert tr._initialized
    # 64 sweeps ran; committed = completed episodes only
    stored = int(tr.replay.n_stored_steps())
    assert 0 < stored <= 64 * N_ENVS
    tr.train_fused(N_ENVS, log_every=10 ** 9, flush=False)
    assert len(tr._pending_logs) > 0        # logs still on the device
    tr._flush_logs()
    assert not tr._pending_logs
    path = os.path.join(tmp_path, "ck.pt")
    tr.save(path)
    before = convert.replay_to_numpy(tr.replay)
    w = tr.params["out"]["W"].detach().clone()
    tr.train_fused(N_ENVS, log_every=10 ** 9)
    tr.restore(path)
    assert torch.equal(tr.params["out"]["W"], w)
    after = convert.replay_to_numpy(tr.replay)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert tr.n_grad_steps == N_ENVS

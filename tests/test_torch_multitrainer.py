"""Port parity: the competing-agents MultiTrainer
(smarties_tpu_torch/runtime/multitrainer.py and replay/multi_collector.py
against smarties_tpu/runtime/multitrainer.py and
replay/multi_collector.py) on predator-prey, one V-RACER learner per
agent, with the per-agent MDPs of tests/test_competing.py.

Random streams cannot match (threefry), so parity goes through the seam
of tests/test_torch_slice.py:
1. Roll to the truncation: bTrain=False (deterministic acting), the JAX
   MultiTrainer's params converted (convert.multitrainer_from_jax), the
   same start positions. Every lane of every env finishes at step 200
   (max_len = MAX_STEPS), so after 201 sweeps both replays hold the same
   episodes; after K1's ingest sweep per learner they agree field by
   field (states, actions, mus and rho rtol 1e-4 / atol 1e-5 after 200
   steps of two nets and the env; values and returns atol 2e-3, one f32
   ulp of the 5100 that scale_net2v cancels).
2. Then each learner's initialize_stats and 4 train steps on pinned
   (ep, t) from that state, and a refresh: params rtol 1e-5 / atol 1e-7,
   the Adam moments rtol 1e-3 / atol 1e-9, the replay's statistics and
   returns as in test_torch_slice.py.
3. The port alone: the twin of
   test_competing.py::test_rollout_commits_to_both_replays; warmup,
   train with a train_mask (the frozen learner bit-unchanged), the
   per-agent reward files, avg_return, evaluate, save / load.
4. `slow`: the twin of test_competing.py::test_both_agents_learn on the
   CPU (the predator learns, then the prey).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.core.mdp import MDPSpec as JMDP
from smarties_tpu.envs import predator_prey as jpp
from smarties_tpu.runtime.multitrainer import MultiTrainer as JMulti
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch.core.mdp import MDPSpec as TMDP
from smarties_tpu_torch.envs import predator_prey as tpp
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.runtime.multitrainer import MultiTrainer
from smarties_tpu_torch.utils.config import HyperParameters as THP

from _torch_parity import (assert_replay_close, assert_tree_close,
                           jax_replay_views, tn, tt)

CFG = dict(minTotObsNum=2000, maxTotObsNum=30000, batchSize=128,
           nnLayerSizes=[24, 24], learnrate=5e-3, gamma=0.95,
           explNoise=0.4, obsPerStep=1.0)
_MDP_KW = dict(dim_state=4, dim_action=2, bounded=(True, True),
               upper_action=(1.0, 1.0), lower_action=(-1.0, -1.0),
               n_agents_per_env=2)


def _mdps(cls):
    """(predator, prey): the prey's descriptor lists its observable dims,
    as in test_competing.py."""
    return [cls(**_MDP_KW), cls(**_MDP_KW, observable=(True,) * 4)]


def _port(n_envs=8, n_slots=64, run_dir=None, **kw):
    cfg = dict(CFG, **kw)
    return MultiTrainer(tpp, _mdps(TMDP), [THP(**cfg), THP(**cfg)],
                        n_envs=n_envs, n_slots=n_slots,
                        max_len=tpp.MAX_STEPS, run_dir=run_dir,
                        device="cpu")


def _jax_snapshot(mt):
    """The JAX MultiTrainer's state as numpy (what its save() pickles,
    the replays as field views)."""
    return {"learners": [
        {"params": jax.device_get(mt.params[a]),
         "opt_state": jax.device_get(mt.opt_states[a]),
         "replay": jax_replay_views(mt.carry.replays[a]),
         "n_grad_steps": mt.n_grad_steps[a]} for a in range(mt.A)],
        "n_env_steps": mt.n_env_steps, "initialized": mt._initialized}


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


def test_roll_to_truncation_then_pinned_train_steps():
    cfg = dict(CFG, nnLayerSizes=[16, 16], batchSize=32, bTrain=False)
    jm = JMulti(jpp, _mdps(JMDP), [JHP(**cfg), JHP(**cfg)], n_envs=8,
                n_slots=64, max_len=jpp.MAX_STEPS)
    pm = MultiTrainer(tpp, _mdps(TMDP), [THP(**cfg), THP(**cfg)], n_envs=8,
                      n_slots=64, max_len=tpp.MAX_STEPS, device="cpu")
    pm.load(convert.multitrainer_from_jax(_jax_snapshot(jm)))
    js = jm.carry.env_state
    u = np.concatenate([np.asarray(js.pred), np.asarray(js.prey)], 1)
    pm.carry = pm.carry._replace(env_state=tpp.init(None, 16, u_new=tt(u)))
    jm._roll(jpp.MAX_STEPS + 1)
    pm._roll(tpp.MAX_STEPS + 1)
    assert pm.n_env_steps == jm.n_env_steps
    for a in range(2):
        jr, pr = jm.carry.replays[a], pm.carry.replays[a]
        assert int(pr.n_stored_eps()) == 8
        assert (tn(pr.length)[tn(pr.valid_slots())] == tpp.MAX_STEPS).all()
        assert_replay_close(jr, pr, fields=(
            "length", "ep_id", "terminal", "n_seen_steps", "n_seen_eps",
            "qret_stale"), rtol=0, atol=0)
        assert_replay_close(jr, pr, fields=("states", "actions", "mus",
                                            "rho", "rewards"),
                            rtol=1e-4, atol=1e-5)
        assert_replay_close(jr, pr, fields=("value", "v_trunc", "qret"),
                            rtol=1e-4, atol=2e-3)
    # the per-agent logs of the episodes: equal lengths, returns close
    assert jm._ep_returns[0] and len(pm._ep_returns[0]) == 0
    pm._flush_logs()
    for a in range(2):
        np.testing.assert_allclose(pm._ep_returns[a], jm._ep_returns[a],
                                   rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.add(pm._ep_returns[0], pm._ep_returns[1]),
                               0.0, atol=1e-3)

    # each learner: initialize_stats, 4 pinned train steps, a refresh
    for a in range(2):
        jl, pl = jm.algos[a], pm.algos[a]
        jp, jo = jm.params[a], jm.opt_states[a]
        tp, to = pm.params[a], pm.opt_states[a]
        jr = jl.initialize_stats(jm.carry.replays[a])
        tr = pl.initialize_stats(pm.carry.replays[a])
        for ep, t in _pinned(jr, a, 4, cfg["batchSize"]):
            jp, jo, jr, _ = jl.train_step(
                jp, jo, jr, jax.random.PRNGKey(0),
                sample_override=(jnp.asarray(ep), jnp.asarray(t)))
            tp, to, tr, _ = pl.train_step(tp, to, tr, sample_override=(
                tt(ep, torch.int32), tt(t, torch.int32)))
        jr = jl.refresh(jr, 1000.0)
        tr = pl.refresh(tr, 1000.0)
        assert_tree_close(tp, jax.device_get(jp), rtol=1e-5, atol=1e-7)
        assert_tree_close(to.m1, jax.device_get(jo.m1), rtol=1e-3,
                          atol=1e-9)
        assert_replay_close(jr, tr, fields=("rho", "kl", "beta",
                                            "cmax_ret", "rew_mean",
                                            "rew_std", "state_mean",
                                            "state_std"),
                            rtol=1e-4, atol=1e-5)
        assert_replay_close(jr, tr, fields=("qret", "delta", "value",
                                            "max_abs_error"),
                            rtol=1e-4, atol=2e-3)


def test_rollout_commits_to_both_replays():
    """test_competing.py::test_rollout_commits_to_both_replays."""
    mt = _port()
    mt._roll(tpp.MAX_STEPS + 2)
    for a in range(2):
        assert int(mt.carry.replays[a].n_stored_eps()) >= 8
    # zero-sum: committed rewards mirror each other
    r0 = mt.carry.replays[0].rewards
    r1 = mt.carry.replays[1].rewards
    v0 = mt.carry.replays[0].valid_steps_tm().t()
    assert float(torch.where(v0, r0 + r1, 0.0).abs().max()) <= 1e-5
    # the default slot count of the JAX MultiTrainer
    assert MultiTrainer(tpp, _mdps(TMDP), THP(**CFG), n_envs=4,
                        max_len=tpp.MAX_STEPS, device="cpu").n_slots \
        == max(256, 2 * CFG["maxTotObsNum"] // max(8, tpp.MAX_STEPS // 8))


def test_warmup_train_mask_logs_eval_and_save(tmp_path):
    mt = _port(run_dir=str(tmp_path), minTotObsNum=1600,
               nnLayerSizes=[16], batchSize=32)
    mt.warmup()
    assert all(mt._initialized)
    assert int(mt.carry.replays[0].n_stored_steps()) >= 1600
    assert mt._start_env_steps == mt.n_env_steps
    for mask in ([True, False], [False, True]):
        frozen = mask.index(False)
        before = [x.detach().clone() for x in tree_leaves(mt.params[frozen])]
        g0 = list(mt.n_grad_steps)
        mt.train_mask = mask
        mt.train(120)
        assert all(torch.equal(x, y) for x, y in
                   zip(before, tree_leaves(mt.params[frozen])))
        assert mt.n_grad_steps[frozen] == g0[frozen]
        assert mt.n_grad_steps[1 - frozen] == g0[1 - frozen] + 120
        # the pacing: a learner never runs ahead of the env steps
        assert mt.n_grad_steps[1 - frozen] <= (
            mt.n_env_steps - mt._start_env_steps) / CFG["obsPerStep"]
    for a in range(2):
        assert all(torch.isfinite(x).all() for x in tree_leaves(mt.params[a]))
    # the per-agent reward files: [grad-step, env-step, agent, length, ret]
    for f in mt._rew_files:
        f.flush()
    rows = [np.loadtxt(tmp_path / f"agent_{a:02d}_rank00_cumulative_"
                       f"rewards.dat", ndmin=2) for a in range(2)]
    for a in range(2):
        assert rows[a].shape[1] == 5 and (rows[a][:, 2] == a).all()
        assert (rows[a][:, 3] == tpp.MAX_STEPS).all()
        assert len(rows[a]) == len(mt._ep_returns[a])
    np.testing.assert_allclose(rows[0][:, 4] + rows[1][:, 4], 0.0,
                               atol=1e-3)
    assert np.isclose(mt.avg_return(0), -mt.avg_return(1), atol=1e-3)
    rets = mt.evaluate(4, max_steps=tpp.MAX_STEPS)
    assert rets.shape == (4, 2) and np.isfinite(rets).all()
    np.testing.assert_allclose(rets.sum(1), 0.0, atol=1e-3)
    # deterministic: the same starts give the same returns, and the
    # evaluation draws its starts from its own generator
    st, reset_st = mt.gen_eval.get_state(), mt.gen_env.get_state()
    first = mt.evaluate(4, 20)
    mt.gen_eval.set_state(st)
    np.testing.assert_array_equal(mt.evaluate(4, 20), first)
    assert torch.equal(mt.gen_env.get_state(), reset_st)
    path = str(tmp_path / "multi.pt")
    mt.save(path)
    state = torch.load(path, weights_only=True)
    assert [ls["n_grad_steps"] for ls in state["learners"]] == mt.n_grad_steps
    fresh = _port(minTotObsNum=1600, nnLayerSizes=[16], batchSize=32)
    fresh.load(state)
    for a in range(2):
        for x, y in zip(tree_leaves(fresh.params[a]),
                        tree_leaves(mt.params[a]), strict=True):
            assert torch.equal(x, y.detach())
        want = convert.replay_to_numpy(mt.carry.replays[a])
        got = convert.replay_to_numpy(fresh.carry.replays[a])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert fresh.n_env_steps == mt.n_env_steps and all(fresh._initialized)
    assert fresh.n_grad_steps == mt.n_grad_steps


@pytest.mark.slow
def test_both_agents_learn():
    """test_competing.py::test_both_agents_learn on the port: phase A
    only the predator trains and its return (-distance) must improve by
    more than 5; phase B only the prey trains and its return must
    recover by more than 5; the two learners hold distinct params."""
    mt = _port(n_envs=32, n_slots=512)
    base = mt.evaluate(n_episodes=16, max_steps=tpp.MAX_STEPS)
    base_pred, base_prey = base.mean(0)
    mt.train_mask = [True, False]
    mt.train(6000, max_wall_s=600)
    mid = mt.evaluate(n_episodes=16, max_steps=tpp.MAX_STEPS)
    mid_pred, mid_prey = mid.mean(0)
    assert mid_pred > base_pred + 5.0, \
        f"predator did not learn: {base_pred:.1f} -> {mid_pred:.1f}"
    mt.train_mask = [False, True]
    mt.train(6000, max_wall_s=600)
    fin = mt.evaluate(n_episodes=16, max_steps=tpp.MAX_STEPS)
    fin_pred, fin_prey = fin.mean(0)
    assert fin_prey > mid_prey + 5.0, \
        f"prey did not learn: {mid_prey:.1f} -> {fin_prey:.1f}"
    p0 = torch.cat([x.detach().reshape(-1) for x in tree_leaves(mt.params[0])])
    p1 = torch.cat([x.detach().reshape(-1) for x in tree_leaves(mt.params[1])])
    assert p0.shape == p1.shape and not torch.allclose(p0, p1)
    print(f"predator {base_pred:.2f} -> {mid_pred:.2f}; prey "
          f"{mid_prey:.2f} -> {fin_prey:.2f}")

"""End-to-end learning of the port: V-RACER on the port's cart-pole.

Twin of tests/test_e2e_cartpole.py::TestCartPoleLearning on the CPU:
the same settings (32 envs, 512 slots, batch 128, learnrate 1e-4,
randSeed 1, 6000 grad steps) and the same two inequalities on a
deterministic eval of 16 episodes. The draws cannot match the JAX
package's (threefry against torch's generators), so this is the
statistical kind of parity: the port must learn as the JAX package does.
`chip_smoke.py` runs the same check on the card.

The two checkpoint cases are the twins of the file's non-slow trainer
tests: a fresh Trainer restored from a checkpoint holds the same
params, counters and replay, and training goes on from there; for a GRU
net the acting carry survives too.

Last, the fused cycle under the prioritized samplers: as in the JAX
package, `train_fused` keeps its cycles for every off-policy learner,
each step drawing its own minibatch from the TD errors the steps before
wrote, and every cycle keeps the obsPerStep invariant exactly.
"""
import numpy as np
import pytest
import torch

from smarties_tpu_torch.envs import cartpole
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters

import _torch_parity  # noqa: F401  (the suite's torch thread cap)

# the settings of the JAX twin (chip_smoke.py runs them on the card)
LEARN_CFG = dict(minTotObsNum=2048, maxTotObsNum=16384, batchSize=128,
                 learnrate=1e-4, obsPerStep=1.0, randSeed=1)
LEARN_STEPS = 6000


def learning_check(device):
    """warmup, base eval, 6000 grad steps, trained eval -> (base, trained,
    trailing noisy return, trainer)."""
    cfg = HyperParameters(**LEARN_CFG)
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=32, n_slots=512,
                 max_len=cartpole.MAX_STEPS, device=device)
    tr.warmup(chunk=32)
    base = float(np.mean(tr.evaluate(16)))
    tr.train(LEARN_STEPS, log_every=10 ** 9)
    trained = float(np.mean(tr.evaluate(16)))
    trail = float(np.mean(tr._ep_returns[-20:]))
    return base, trained, trail, tr


@pytest.mark.slow
def test_vracer_improves():
    base, trained, trail, _ = learning_check("cpu")
    # a random policy survives ~25-40 steps; after 6k grad steps the
    # deterministic policy must be clearly better
    assert trained > base + 30, (base, trained, trail)
    assert trained > 80, (trained, trail)


def _small_trainer(extra=None):
    cfg = HyperParameters(**{"minTotObsNum": 256, "maxTotObsNum": 1024,
                             "batchSize": 32, "obsPerStep": 1.0,
                             **(extra or {})})
    return Trainer(cartpole, cartpole.MDP, cfg, n_envs=8, n_slots=64,
                   max_len=64, device="cpu")


@pytest.mark.parametrize("extra", [
    dict(nnLayerSizes=[32, 32]),
    dict(nnLayerSizes=[16], nnType="GRU", nnBPTTseq=4),
], ids=["ffnn", "gru"])
def test_checkpoint_roundtrip(tmp_path, extra):
    tr = _small_trainer(extra)
    tr.warmup(chunk=16)
    tr.train(20, log_every=10 ** 9)
    path = str(tmp_path / "ckpt.pt")
    tr.save(path)
    tr2 = _small_trainer(extra)
    tr2.restore(path)
    assert tr2.n_grad_steps == tr.n_grad_steps
    assert tr2.n_env_steps == tr.n_env_steps
    assert torch.equal(tr2.params["out"]["W"], tr.params["out"]["W"].detach())
    assert torch.equal(tr2.replay.slot_len, tr.replay.slot_len)
    rnn = tree_leaves(tr2.carry.rnn)
    for a, b in zip(rnn, tree_leaves(tr.carry.rnn), strict=True):
        assert torch.equal(a, b)
    if extra.get("nnType"):
        assert rnn and any(bool(x.abs().sum() > 0) for x in rnn)
    # resumed training continues (counters preserved => pacing resumes)
    tr2.train(10, log_every=10 ** 9)
    assert tr2.n_grad_steps == tr.n_grad_steps + 10


@pytest.mark.parametrize("algo,obs_per_step", [
    ("PERrank", 1.0), ("PERerr", 2.0), ("PERseq", 1.0)])
def test_fused_cycle_prioritized(algo, obs_per_step):
    tr = _small_trainer(dict(nnLayerSizes=[16], dataSamplingAlgo=algo,
                             obsPerStep=obs_per_step))
    assert not tr._can_presample
    tr.warmup(chunk=16)
    cycles = []
    fused = tr._fused_cycle
    tr._fused_cycle = lambda *a: cycles.append(a) or fused(*a)
    g0, e0 = tr.n_grad_steps, tr.n_env_steps
    d0 = tr.replay.delta_tm.clone()
    tr.train_fused(24, log_every=10 ** 9)
    n_train = int(tr.n_envs / obs_per_step)
    assert cycles == [(1, n_train)] * (24 // n_train)
    assert tr.n_grad_steps - g0 == 24
    # one env sweep of n_envs observations per n_envs / obsPerStep steps
    assert tr.n_env_steps - e0 == (tr.n_grad_steps - g0) * obs_per_step
    assert not torch.equal(tr.replay.delta_tm, d0)
    assert all(torch.isfinite(v).all() for v in tr._last_metrics.values())

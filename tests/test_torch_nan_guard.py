"""NaN guards of the port (the twin of tests/test_nan_guard.py; the
reference checks every message, Agent::checkNanOrInf, Agent.h:301-313,
Communicator.cpp:267-270).

- The Engine raises on a non-finite state an app sends. The app is the
  JAX test's `nan_app` as an env object served in the test's own
  process (tests/_torch_engine_pools.py's lockstep pool, no fork): the
  initial state, then a NaN state.
- The Trainer with debugNaN raises after a train chunk on a poisoned
  replay (non-finite returns), instead of training on garbage; a chunk
  of the fused cycle too.
"""
import numpy as np
import pytest
import torch

from smarties_tpu_torch.envs import cartpole
from smarties_tpu_torch.runtime import communicator as tcomm
from smarties_tpu_torch.runtime.engine import Engine
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters

from _torch_engine_pools import CONT, LockstepPool, app_spec


class NanEnv:
    """nan_app of tests/test_nan_guard.py: a zero initial state, then a
    poisoned one."""

    def reset(self):
        return np.zeros(1)

    def step(self, action):
        return np.array([float("nan")]), 0.5, CONT


def _describe(comm):
    comm.setStateActionDims(1, 1)
    comm.setActionScales([1.0], [-1.0], True)


def test_engine_nan_state_raises():
    e = Engine([], device="cpu")
    e.setNEnvironments(1)
    e.setSettings(HyperParameters(minTotObsNum=16, maxTotObsNum=64,
                                  batchSize=8, nnLayerSizes=[8]))
    e.setNTrainSteps(5)
    e.setMaxEpisodeLength(16)
    pool = LockstepPool(app_spec(tcomm.Communicator, _describe), [NanEnv()],
                        tcomm.spec_to_mdp, tcomm.spec_to_mdps)
    with pytest.raises(FloatingPointError, match="non-finite"):
        e.run(None, pool=pool, max_wall_s=60)


@pytest.mark.parametrize("loop", ["train", "train_fused"])
def test_debug_nan_catches_divergence(loop):
    cfg = HyperParameters(minTotObsNum=128, maxTotObsNum=1024, batchSize=16,
                          nnLayerSizes=[8, 8], debugNaN=True)
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=8, n_slots=32,
                 max_len=64, device="cpu")
    tr.warmup(chunk=16)
    # corrupt the stored return estimates
    tr.replay.qret_tm.fill_(float("nan"))
    assert not torch.isfinite(tr.replay.qret_tm).any()
    with pytest.raises(FloatingPointError, match="non-finite"):
        getattr(tr, loop)(100, log_every=10 ** 9)

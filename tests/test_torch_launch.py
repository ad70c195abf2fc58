"""The port's launcher (python -m smarties_tpu_torch.launch) on the CPU.

Each built-in app runs with a fitting recipe, cut to a tiny size
(16-wide nets, batch 16, 8 envs, 64-step episodes) in a settings json:
40 grad steps with finite params, as tests/test_all_algos.py::run_algo
asks of the JAX Trainer. The run directory must hold the settings.json
the JAX launcher writes for the same recipe (its HyperParameters.
to_dict(), computed here in-process), the git provenance files,
cumulative-reward rows of 5 columns, and a checkpoint.pt that restores
into a fresh Trainer exactly (params with their targets, the optimiser
state — MixedPG's included —, the replay and the acting carry).
PPO (continuous, discrete and ppoStandard) runs whole horizon cycles
without a warmup, the recurrent recipes (RACER_RNN, the GRU recipe
VRACER_expensiveData, and LSTM / GRU / RNN nets under DQN, NAF, DPG and
PPO) run with a BPTT window of 4. `catch` runs the RACER_atari recipe
(Mnih conv stack, 4 stacked frames) on a uint8 replay; three learners and
PPO run under a prioritized sampler, with the farpolfrac / maxkldiv /
minerror episode filters. Unsupported apps and learners raise
NotImplementedError naming their ROADMAP item.
"""
import json

import numpy as np
import pytest
import torch

from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu.utils.recipes import RECIPES as JRECIPES
from smarties_tpu_torch import launch
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.runtime.trainer import _plain
from smarties_tpu_torch.utils.recipes import RECIPES

from _torch_parity import tn

TINY = dict(nnLayerSizes=[16], batchSize=16, minTotObsNum=256,
            maxTotObsNum=1024)
# minTotObsNum stays above the horizon, as in the published PPO settings:
# an on-policy learner never reads it
PPO_TINY = dict(encoderLayerSizes=[16], maxTotObsNum=128, obsPerStep=4.0)
RNN_TINY = dict(nnLayerSizes=[8, 8], nnBPTTseq=4, minTotObsNum=128)
# (app, recipe, extra settings) -> the learner class it builds
CASES = [
    ("cartpole", "VRACER", {}, "VRacer"),
    ("cartpole", "RACER", {}, "Racer"),
    ("cartpole", "default", {"learner": "MixedPG"}, "MixedPG"),
    ("cartpole_discrete", "RACER", {}, "Racer"),
    ("cartpole_discrete", "DQN", {}, "DQN"),
    ("pendulum", "NAF", {}, "NAF"),
    ("pendulum", "DPG", {"encoderLayerSizes": [16]}, "DPG"),
    ("acrobot", "DQN", {"dqnEpsGreedy": True}, "DQN"),
    ("mountaincar", "DPG_orig", {"encoderLayerSizes": [16]}, "DPG"),
    # on-policy: the horizon is maxTotObsNum, 4 epochs of 8 updates
    ("cartpole", "PPO", dict(PPO_TINY), "PPO"),
    ("cartpole_discrete", "PPO", dict(PPO_TINY, ppoStandard=True), "PPO"),
    ("pendulum", "PPO", dict(PPO_TINY, nnType="LSTM", **RNN_TINY), "PPO"),
    # recurrent nets
    ("cartpole_pomdp", "RACER_RNN", dict(RNN_TINY), "VRacer"),
    ("cartpole_pomdp", "VRACER_expensiveData", dict(RNN_TINY), "VRacer"),
    ("cartpole", "RACER", dict(RNN_TINY, nnType="RNN"), "Racer"),
    ("cartpole_discrete", "DQN", dict(RNN_TINY, nnType="LSTM"), "DQN"),
    ("pendulum", "NAF", dict(RNN_TINY, nnType="GRU"), "NAF"),
    ("pendulum", "DPG", dict(RNN_TINY, nnType="LSTM",
                             encoderLayerSizes=[0]), "DPG"),
    # the pixel env: Mnih conv stack, 4 stacked frames, uint8 replay
    ("catch", "RACER_atari", {"maxTotObsNum": 512}, "Racer"),
    # prioritized samplers and the other episode filters
    ("cartpole", "VRACER", {"dataSamplingAlgo": "PERrank",
                            "ERoldSeqFilter": "farpolfrac"}, "VRacer"),
    ("cartpole_discrete", "DQN", {"dataSamplingAlgo": "PERerr",
                                  "ERoldSeqFilter": "maxkldiv"}, "DQN"),
    ("pendulum", "NAF", {"dataSamplingAlgo": "PERseq",
                         "ERoldSeqFilter": "minerror"}, "NAF"),
    ("cartpole", "PPO", dict(PPO_TINY, dataSamplingAlgo="PERrank"), "PPO"),
]


def _case_id(app, recipe, extra, cls):
    tags = (extra.get("nnType"), "std" if extra.get("ppoStandard") else None,
            recipe if "pomdp" in app else None,
            extra.get("dataSamplingAlgo"))
    return "-".join([app, cls] + [t for t in tags if t])


def _args(tmp_path, app, recipe, *extra):
    return launch.parse_args([
        app, "--recipe", str(recipe), "--device", "cpu", "--runprefix",
        str(tmp_path), "--runname", "r0", "--nEnvironments", "8",
        "--nTrainSteps", "40", "--maxEpisodeLength", "64", "--randSeed",
        "3", *extra])


def test_recipes_are_the_jax_recipes():
    assert RECIPES == JRECIPES


@pytest.mark.parametrize("app,recipe,extra,cls", CASES,
                         ids=[_case_id(*case) for case in CASES])
def test_launch_builtin(tmp_path, app, recipe, extra, cls):
    path = tmp_path / "recipe.json"
    path.write_text(json.dumps({**RECIPES[recipe], **TINY, **extra}))
    args = _args(tmp_path, app, path)
    tr = launch.run(args)
    assert type(tr.algo).__name__ == cls
    assert tr.n_grad_steps >= 40
    assert tr.replay.states_tm.dtype == (torch.uint8 if app == "catch"
                                         else torch.float32)
    assert all(torch.isfinite(x).all() for x in tree_leaves(tr.params))
    run = tmp_path / "r0"
    want = JHP.from_json(str(path))
    want.randSeed = 3
    got = json.loads((run / "settings.json").read_text())
    assert got == json.loads(json.dumps(want.to_dict()))
    assert (run / "gitlog.log").exists() and (run / "gitdiff.log").exists()
    rows = np.loadtxt(run / "agent_00_rank00_cumulative_rewards.dat",
                      ndmin=2)
    assert len(rows) > 0 and rows.shape[1] == 5

    fresh = launch.make_trainer(args)
    fresh.restore(str(run / "checkpoint.pt"))
    for a, b in zip(tree_leaves(fresh.params), tree_leaves(tr.params),
                    strict=True):
        assert torch.equal(a, b.detach())
    for a, b in zip(tree_leaves(_plain(fresh.opt_state)),
                    tree_leaves(_plain(tr.opt_state)), strict=True):
        assert torch.equal(a, b)
    assert type(fresh.opt_state) is type(tr.opt_state)
    for a, b in zip(tree_leaves(fresh.carry.rnn), tree_leaves(tr.carry.rnn),
                    strict=True):
        assert torch.equal(a, b)
    assert len(fresh.carry.rnn) == len(tr.carry.rnn)
    if tr.on_policy:
        # whole horizon cycles of 4 epochs x 8 updates, no warmup
        assert tr.n_grad_steps % 32 == 0 and tr.n_grad_steps < 40 + 32
        # a warmup would stop at the horizon, below minTotObsNum
        assert tr.n_obs_b4_start == tr.cfg.maxTotObsNum <= tr.cfg.minTotObsNum
    before = convert.replay_to_numpy(tr.replay)
    after = convert.replay_to_numpy(fresh.replay)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    assert fresh.n_grad_steps == tr.n_grad_steps
    rets = fresh.evaluate(2, max_steps=20)
    assert np.isfinite(rets).all()


@pytest.mark.parametrize("app,recipe,extra,item", [
    ("glider", "VRACER", (), "B10"),
    ("predator_prey", "VRACER", (), "B10"),
    ("catch", "VRACER", ("--nLearners", "2"), "B12"),
    ("apps/cart_pole_py/exec.py", "VRACER", (), "B11"),
    ("cartpole", "VRACER", ("--nLearners", "2"), "B12"),
    ("cartpole", "CMA", (), "B8"),
    ("cartpole", "ACER", (), "B7"),
    ("cartpole", "VRACER_CMA", (), "B8"),
    ("cartpole", '{"learner": "ACER", "dataSamplingAlgo": "PERrank"}', (),
     "B7"),
    ("cartpole", '{"nnType": "LSTM", "ESpopSize": 4}', (), "B8"),
])
def test_not_ported_raises(tmp_path, app, recipe, extra, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        launch.run(_args(tmp_path, app, recipe, *extra))


def test_device_is_required():
    with pytest.raises(SystemExit):
        launch.parse_args(["cartpole"])

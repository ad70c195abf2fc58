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
minerror episode filters. ACER (episode windows, with its split Adam)
and RACER-ES (VRACER_CMA, a population of 4 here; RACER-ES with the
Gaussian and the discrete advantage) run and restore the same way; ACER
under PERrank keeps its own episode draw. CMA trains whole generations
through the launcher and writes no checkpoint, as the JAX launcher does.
Every recipe of utils/recipes.py builds, at its published widths, the
learner the JAX registry builds for it (CMA: the CMAES).
--nLearners 2 trains two gloo ranks on the CPU, whose checkpoint restores
into one process; the app-script path and CMA run one process under it,
as the JAX launcher does; a rank count that does not divide the lanes
raises, and on the card so does one rank more than there are cards.
The glider (RACER_glider) and predator-prey (VRACER, both agents' lanes
feeding one learner) run through the launcher as the other apps do.
"""
import json

import numpy as np
import pytest
import torch

from smarties_tpu import envs as jenvs
from smarties_tpu.algos.registry import make_learner as jmake
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu.utils.recipes import RECIPES as JRECIPES
from smarties_tpu_torch import launch
from smarties_tpu_torch.algos.registry import make_learner
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
    # ACER's episode windows (S = min(200, 64) here) and RACER-ES
    ("pendulum", "ACER", dict(encoderLayerSizes=[16]), "ACER"),
    ("pendulum", "ACER", dict(encoderLayerSizes=[16],
                              dataSamplingAlgo="PERrank"), "ACER"),
    ("cartpole", "VRACER_CMA", dict(ESpopSize=4), "RacerES"),
    ("cartpole", "RACER", dict(ESpopSize=4), "RacerES"),
    ("cartpole_discrete", "RACER", dict(ESpopSize=4), "RacerES"),
    # the glider (64-step episodes here: the launcher's cap) and
    # predator-prey's 8 lanes of 4 envs x 2 agents, one shared learner
    ("glider", "RACER_glider", {}, "Racer"),
    ("predator_prey", "VRACER", {}, "VRacer"),
]


def _case_id(app, recipe, extra, cls):
    tags = (extra.get("nnType"), "std" if extra.get("ppoStandard") else None,
            recipe if "pomdp" in app or cls == "RacerES" or app == "glider"
            else None,
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


def test_launch_learners_cpu(tmp_path):
    """--nLearners 2 on the CPU: two gloo ranks of 4 lanes each train
    one policy; rank 0 writes the settings, the rewards of both ranks'
    lanes and one checkpoint.pt, which restores into one process."""
    path = tmp_path / "recipe.json"
    path.write_text(json.dumps({**RECIPES["VRACER"], **TINY}))
    args = _args(tmp_path, "cartpole", path, "--nLearners", "2")
    assert launch.run(args) is None         # the ranks ran in their own
    run = tmp_path / "r0"
    got = json.loads((run / "settings.json").read_text())
    assert got["batchSize"] == TINY["batchSize"]
    rows = np.loadtxt(run / "agent_00_rank00_cumulative_rewards.dat",
                      ndmin=2)
    assert rows.shape[1] == 5
    assert {int(a) // 4 for a in rows[:, 2]} == {0, 1}   # both ranks
    one = launch.make_trainer(_args(tmp_path, "cartpole", path))
    one.restore(str(run / "checkpoint.pt"))
    assert one.n_grad_steps >= 40
    assert one.replay.n_slots == one.n_slots
    assert all(torch.isfinite(x).all() for x in tree_leaves(one.params))
    assert int(one.replay.samp_csum[-1]) == int(one.replay.n_stored_steps())


APP_TINY = {"nnLayerSizes": [16, 16], "batchSize": 16, "minTotObsNum": 128,
            "maxTotObsNum": 1024}


@pytest.mark.parametrize("app,recipe,n_envs,kind", [
    ("apps/cart_pole_py/exec.py", json.dumps(APP_TINY), "2", "Engine"),
    ("cartpole", json.dumps({**RECIPES["CMA"], "ESpopSize": 4,
                             "batchSize": 2, "nnLayerSizes": [8]}), "8",
     "CMAES"),
])
def test_learners_one_process_paths(tmp_path, app, recipe, n_envs, kind):
    """As the JAX launcher does, the app-script path (the Engine) and CMA
    run one process whatever --nLearners says."""
    args = launch.parse_args([
        app, "--recipe", recipe, "--device", "cpu", "--runprefix",
        str(tmp_path), "--runname", "r0", "--nEnvironments", n_envs,
        "--nTrainSteps", "2" if kind == "CMAES" else "30",
        "--maxEpisodeLength", "256", "--nLearners", "2"])
    out = launch.run(args)
    assert type(out).__name__ == kind
    assert (tmp_path / "r0" / "settings.json").exists()


def test_learners_must_divide_lanes(tmp_path):
    args = _args(tmp_path, "cartpole", json.dumps(TINY), "--nLearners",
                 "3", "--nEnvironments", "16")
    with pytest.raises(ValueError, match="must divide --nEnvironments"):
        launch.run(args)


@pytest.mark.cuda
def test_learners_more_than_cards_raise(tmp_path):
    """NCCL takes one rank per card: one rank more than there are cards
    raises before any rank starts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    n = torch.cuda.device_count() + 1
    args = _args(tmp_path, "cartpole", json.dumps(TINY), "--device",
                 "cuda", "--nLearners", str(n), "--nEnvironments",
                 str(8 * n))
    with pytest.raises(ValueError, match="one rank per card"):
        launch.run(args)


def test_launch_cma(tmp_path):
    """CMA through the launcher: --nTrainSteps counts generations, each
    of batchSize x ESpopSize episodes; no checkpoint is written."""
    path = tmp_path / "recipe.json"
    path.write_text(json.dumps({**RECIPES["CMA"], "ESpopSize": 4,
                                "batchSize": 2, "nnLayerSizes": [8]}))
    args = launch.parse_args([
        "cartpole", "--recipe", str(path), "--device", "cpu", "--runprefix",
        str(tmp_path), "--runname", "r0", "--nEnvironments", "8",
        "--nTrainSteps", "2", "--randSeed", "3"])
    cma = launch.run(args)
    assert type(cma).__name__ == "CMAES" and cma.n_generations == 2
    assert int(cma.state.gen) == 2 and cma.max_len == 512
    assert all(np.isfinite(h["avgR"]) for h in cma.history)
    assert torch.isfinite(cma.state.mean).all()
    run = tmp_path / "r0"
    assert json.loads((run / "settings.json").read_text())["ESpopSize"] == 4
    assert not (run / "checkpoint.pt").exists()
    assert np.isfinite(cma.evaluate(2, max_steps=20)).all()


@pytest.mark.parametrize("app,recipe,extra,match", [
    ("cartpole", "CMA", ("--nEnvironments", "64"), "multiple of ESpopSize"),
    ("cartpole_discrete", "ACER", (), "continuous action spaces only"),
    ("cartpole", '{"nnType": "LSTM", "ESpopSize": 4}', (),
     "dense feed-forward net only"),
])
def test_refused_settings(tmp_path, app, recipe, extra, match):
    with pytest.raises(ValueError, match=match):
        launch.run(_args(tmp_path, app, recipe, *extra))


# the app a recipe is built for here (its MDP sets the learner's heads);
# the others build on cartpole
RECIPE_APPS = {"RACER_atari": "catch", "DQN": "cartpole_discrete",
               "RACER_RNN": "cartpole_pomdp",
               "VRACER_expensiveData": "cartpole_pomdp", "ACER": "pendulum",
               "NAF": "pendulum", "DPG": "pendulum", "DPG_light": "pendulum",
               "DPG_orig": "mountaincar"}
JAX_MDPS = {"cartpole": lambda: jenvs.cartpole.MDP,
            "cartpole_discrete": lambda: jenvs.cartpole.discrete.MDP,
            "cartpole_pomdp": lambda: jenvs.cartpole.pomdp.MDP,
            "pendulum": lambda: jenvs.pendulum.MDP,
            "mountaincar": lambda: jenvs.mountaincar.MDP,
            "catch": lambda: jenvs.catch.MDP}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_every_recipe_builds(recipe):
    """Every recipe's learner, as the JAX registry picks it, built and
    initialised on the CPU at the recipe's widths; CMA, which the
    registry refuses, builds its CMAES."""
    app = RECIPE_APPS.get(recipe, "cartpole")
    env = launch.env_module(app)
    cfg = launch.load_recipe(recipe, 0)
    if cfg.learner == "CMA":
        from smarties_tpu_torch.algos.cma import CMAES
        with pytest.raises(ValueError, match="CMAES"):
            make_learner(env.MDP, cfg)
        cma = CMAES(env, env.MDP, cfg, n_envs=2 * cfg.ESpopSize,
                    device="cpu")
        st = cma.init()
        assert st.pop.shape == (cfg.ESpopSize, cma.unravel.n)
        assert torch.isfinite(st.pop).all()
        return
    algo = make_learner(env.MDP, cfg)
    want = jmake(JAX_MDPS[app](), JHP.from_dict(RECIPES[recipe]))
    assert type(algo).__name__ == type(want).__name__
    params, opt = algo.init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    assert all(torch.isfinite(x).all() for x in tree_leaves(_plain(opt)))


def test_device_is_required():
    """--device defaults to the card, and a card that is missing raises:
    nothing falls back to the CPU."""
    args = launch.parse_args(["cartpole"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        for app in ("cartpole", "apps/cart_pole_py/exec.py"):
            args = launch.parse_args([app, "--runprefix", "unused"])
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                launch.run(args)

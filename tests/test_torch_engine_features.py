"""The port's Engine capabilities over forked apps, on the CPU: twins of
tests/test_engine_features.py.

- per-agent MDPs -> one learner each (competing agents), their
  checkpoint, per-learner settings (settings_%02u.json, programmatic)
  and a mixed-algorithm run (DPG beside RACER-discrete);
- LSTM serving with per-agent contexts that advance;
- per-sim directories, the setup-folder copy and staged app arguments;
- a crashing app: the episode dropped, the app respawned, training done;
- the eval CLI flags, and distributed agents exclusive of per-agent MDPs.

The crash twin takes its sentinel file from tmp_path (the JAX test's
fixed path may be in use by that test in another worker). Each test
asserts counts and files, never a rate.
"""
import json
import os

import numpy as np
import pytest
import torch

import smarties_tpu_torch
from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.runtime.communicator import Communicator
from smarties_tpu_torch.utils.config import HyperParameters

# torch at 1 thread beside the other test workers (tests/_torch_parity.py)
import _torch_parity  # noqa: F401


def cfg(**kw):
    d = dict(minTotObsNum=128, maxTotObsNum=1024, batchSize=32,
             nnLayerSizes=[16, 16])
    d.update(kw)
    return HyperParameters(**d)


def _engine(n_envs, steps, max_len, settings):
    e = smarties_tpu_torch.Engine([], device="cpu")
    e.setNEnvironments(n_envs)
    e.setSettings(settings)
    e.setNTrainSteps(steps)
    e.setMaxEpisodeLength(max_len)
    return e


# a 2-agent competing app with DIFFERENT per-agent MDPs: agent 0 is a 1-D
# continuous chaser, agent 1 a discrete evader on the same line
def competing_app(comm):
    comm.setNumAgents(2)
    comm.agentsDefineDifferentMDP()
    comm.setStateActionDims(2, 1, 0)
    comm.setActionScales([1.0], [-1.0], True, 0)
    comm.setStateActionDims(3, 1, 1)          # evader sees an extra dim
    comm.setActionOptions(3, 1)               # discrete: left/stay/right
    rng = np.random.RandomState(comm.env_id)
    x0, x1 = rng.uniform(-1, 1, 2)
    comm.sendInitState(np.array([x0, x1 - x0]), 0)
    comm.sendInitState(np.array([x1, x1 - x0, 0.0]), 1)
    for t in range(40):
        a0 = comm.recvAction(0)
        a1 = comm.recvDiscreteAction(1)
        x0 = np.clip(x0 + 0.1 * float(a0[0]), -2, 2)
        x1 = np.clip(x1 + 0.1 * (a1 - 1), -2, 2)
        d = abs(x1 - x0)
        send = comm.sendLastState if t == 39 else comm.sendState
        send(np.array([x0, x1 - x0]), -d, 0)
        send(np.array([x1, x1 - x0, float(t) / 40]), d, 1)


def test_two_learners_train(tmp_path):
    e = _engine(2, 30, 64, cfg(minTotObsNum=64, maxTotObsNum=512))
    e.run_dir = str(tmp_path)
    e.run(competing_app, max_wall_s=120)
    assert len(e.learners) == 2
    b0, b1 = e.learners
    # distinct MDPs routed to distinct learners
    assert b0.mdp.dim_state == 2 and not b0.mdp.is_discrete
    assert b1.mdp.dim_state == 3 and b1.mdp.is_discrete
    assert b0.lanes == [0, 2] and b1.lanes == [1, 3]
    # both gathered data and both trained
    assert b0.n_env_steps > 0 and b1.n_env_steps > 0
    assert b0.n_grad >= 30 and b1.n_grad >= 30
    assert int(b0.rs.n_stored_eps()) > 0 and int(b1.rs.n_stored_eps()) > 0
    # the checkpoint holds both learners
    snap = torch.load(tmp_path / "checkpoint.pt", weights_only=True)
    assert len(snap["learners"]) == 2


def lstm_app(comm):
    """1-D integrator with partial observation (needs memory)."""
    comm.setStateActionDims(1, 1)
    comm.setActionScales([1.0], [-1.0], True)
    rng = np.random.RandomState(comm.env_id)
    x = rng.uniform(-1, 1)
    comm.sendInitState(np.array([x]))
    for t in range(20):
        a = comm.recvAction()
        x = np.clip(x + 0.1 * float(a[0]), -2, 2)
        if t == 19:
            comm.sendLastState(np.array([x]), -abs(x))
        else:
            comm.sendState(np.array([x]), -abs(x))


def test_lstm_over_envpool():
    """LSTM V-RACER serving external envs: per-agent recurrent carry."""
    e = _engine(2, 10, 32, cfg(nnType="LSTM", nnLayerSizes=[8, 8],
                               minTotObsNum=64, maxTotObsNum=512,
                               nnBPTTseq=4))
    e.run(lstm_app, max_wall_s=120)
    assert e.n_grad_steps >= 10
    # the serving carry exists and was advanced (nonzero states)
    rnn = e.learners[0].rnn
    assert len(rnn) > 0
    assert any(float(x.abs().sum()) > 0 for x in tree_leaves(rnn))


def _crashing_app(sentinel):
    def app(comm):
        """Hard-crashes mid-episode exactly once (the sentinel file marks
        that the crash happened, visible across respawns)."""
        comm.setStateActionDims(1, 1)
        comm.setActionScales([1.0], [-1.0], True)
        rng = np.random.RandomState(os.getpid())
        while True:
            x = rng.uniform(-1, 1)
            comm.sendInitState(np.array([x]))
            for t in range(10):
                a = comm.recvAction()
                x += 0.1 * float(a[0])
                if (comm.env_id == 0 and t == 3
                        and not os.path.exists(sentinel)):
                    open(sentinel, "w").close()
                    os._exit(1)     # simulated app crash
                if t == 9:
                    comm.sendLastState(np.array([x]), -abs(x))
                else:
                    comm.sendState(np.array([x]), -abs(x))
    return app


def test_crash_drops_episode_and_respawns(tmp_path):
    sentinel = str(tmp_path / "crashed")
    e = _engine(2, 5, 32, cfg(minTotObsNum=48, maxTotObsNum=512))
    e.run(_crashing_app(sentinel), max_wall_s=120)
    # training completed despite the crash; episodes from the healthy env
    # (and the respawned one) were stored
    assert os.path.exists(sentinel)
    assert e.n_grad_steps >= 5
    assert int(e.replay.n_stored_eps()) > 0


def simdir_app(comm):
    """Records its CWD + staged args (one short episode)."""
    comm.setStateActionDims(1, 1)
    comm.setActionScales([1.0], [-1.0], True)
    with open("app_was_here.txt", "a") as f:
        f.write(" ".join(comm.app_arguments) + "\n")
    comm.sendInitState(np.zeros(1))
    for t in range(5):
        comm.recvAction()
        (comm.sendLastState if t == 4 else comm.sendState)(np.zeros(1), 1.0)


def test_per_sim_dirs_and_staged_args(tmp_path):
    """Per-launch simulation_%03u_%05u dirs + setup-folder copy + staged
    app arg-files switching on the child's env-step counter
    (Core/Launcher.cpp:122-236)."""
    d = str(tmp_path)
    setup = os.path.join(d, "setup")
    os.makedirs(setup)
    open(os.path.join(setup, "data.cfg"), "w").write("cfg")
    for i, txt in enumerate(["--stage one", "--stage 'two words'"]):
        open(os.path.join(d, f"args{i}.txt"), "w").write(txt)
    e = _engine(1, 8, 16, cfg(minTotObsNum=16, maxTotObsNum=256,
                              batchSize=8))
    e.run_dir = d
    e.setSimulationArgumentsFilePath(
        os.path.join(d, "args0.txt") + "," + os.path.join(d, "args1.txt"),
        "10,0")
    e.setSimulationSetupFolderPath(setup)
    e.run(simdir_app, max_wall_s=120)
    sims = sorted(f for f in os.listdir(d) if f.startswith("simulation_000_"))
    assert len(sims) >= 3, sims
    # setup folder copied into each sim dir + app ran there
    for s in sims[:3]:
        assert os.path.exists(os.path.join(d, s, "data.cfg"))
    # stage 0 args for the first launches (<10 steps), stage 1 later
    first = open(os.path.join(d, sims[0], "app_was_here.txt")).read()
    assert "--stage one" in first
    last = open(os.path.join(d, sims[-1], "app_was_here.txt")).read()
    assert "two words" in last    # quoted group == one token rejoined


def test_eval_cli_flags(tmp_path):
    """--nEvalEpisodes / --bTrain parse to eval mode with restart
    defaulting to run_dir; --device picks the learners' device."""
    rd = str(tmp_path / "rd")
    e = smarties_tpu_torch.Engine(["prog", "--nEvalEpisodes", "7",
                                   "--runDir", rd])
    assert not e.parse()
    assert e.cfg.bTrain == 0 and e.n_eval_episodes == 7
    assert e.restart_path == os.path.join(rd, "checkpoint.pt")
    assert e.device == "cuda"
    e2 = smarties_tpu_torch.Engine(["prog", "--bTrain", "0", "--restart",
                                    "x.pt", "--device", "cpu"])
    assert not e2.parse()
    assert e2.cfg.bTrain == 0 and e2.restart_path == "x.pt"
    assert e2.device == "cpu"
    e3 = smarties_tpu_torch.Engine(["prog"])
    assert not e3.parse()
    assert e3.cfg.bTrain == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            e3.run(simdir_app)


def test_distributed_agents_mutually_exclusive():
    """The reference die()s on the combination (Communicator.cpp:200-205)."""
    c = Communicator(conn=None)
    c.setNumAgents(2)
    c.agentsDefineDifferentMDP()
    with pytest.raises(AssertionError):
        c.envHasDistributedAgents()
    c2 = Communicator(conn=None)
    c2.setNumAgents(2)
    c2.envHasDistributedAgents()
    with pytest.raises(AssertionError):
        c2.agentsDefineDifferentMDP()


def test_settings_json_and_programmatic(tmp_path):
    e = smarties_tpu_torch.Engine([], device="cpu")
    e.run_dir = str(tmp_path)
    e.setSettings(cfg())                       # shared default: VRACER
    with open(tmp_path / "settings_01.json", "w") as f:
        json.dump({"learner": "DPG", "batchSize": 16, "learnrate": 1e-5,
                   "minTotObsNum": 128, "maxTotObsNum": 1024,
                   "nnLayerSizes": [16, 16]}, f)
    c0, c1 = e._resolve_learner_cfg(0), e._resolve_learner_cfg(1)
    assert c0.learner == "VRACER" and c0.batchSize == 32
    assert c1.learner == "DPG" and c1.batchSize == 16
    e.setLearnerSettings(1, cfg(learner="NAF"))
    assert e._resolve_learner_cfg(1).learner == "NAF"


def test_mixed_algo_engine_run():
    """The competing app trained with DPG on the continuous agent 0 and
    V-RACER (-> RACER-discrete) on agent 1: distinct algorithms."""
    from smarties_tpu_torch.algos.dpg import DPG
    from smarties_tpu_torch.algos.vracer import VRacer
    e = _engine(2, 25, 64, cfg(minTotObsNum=64, maxTotObsNum=512))
    e.setLearnerSettings(0, cfg(learner="DPG", minTotObsNum=64,
                                maxTotObsNum=512, batchSize=16))
    e.run(competing_app, max_wall_s=120)
    assert len(e.learners) == 2
    assert isinstance(e.learners[0].algo, DPG)
    assert isinstance(e.learners[1].algo, VRacer)
    assert e.learners[0].n_grad >= 25 and e.learners[1].n_grad >= 25

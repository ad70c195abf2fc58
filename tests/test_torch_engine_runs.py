"""The port's Engine serving forked and native apps, on the CPU.

Twins of tests/test_external_env.py (the Python app, the C++ app over
sockets, the C++ distributed-agent team) and
tests/test_engine_lifecycle.py (train -> checkpoint.pt -> restart
continues the counters -> eval serves with no grad step), the launcher
on an app script, and CMAES.run_external: on apps/func_maximization's
forked apps for a few generations (the mean moves toward the optimum),
and one generation against the JAX package's run_external on an
in-process lockstep pool, the population's draws injected through the
`z` seam. Each test asserts counts and files, never a rate.

The native clients build with `make -C native BUILD=<repo>/build/native`
(all of them in this one file, so that no two workers build at once);
the tests skip without g++, as the JAX ones do.

Tolerances of the CMA generation (the JAX CMAState converted, the same
one-step episodes, deterministic actions): the members' losses rtol
1e-5 / atol 1e-6; the new mean, sigmas, path and population rtol 1e-5 /
atol 1e-6 (elementwise f32 updates of the same ranking); counts exact.
"""
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

import smarties_tpu_torch
from smarties_tpu.algos.cma import CMAES as JCMAES
from smarties_tpu.runtime import communicator as jcomm
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch import launch
from smarties_tpu_torch.algos.cma import CMAES
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.runtime import communicator as tcomm
from smarties_tpu_torch.runtime.env_pool import EnvPool
from smarties_tpu_torch.utils.config import HyperParameters

from _torch_engine_pools import (FuncMaximization, LockstepPool, load_app,
                                 func_maximization_spec)
from _torch_parity import tn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_BUILD = os.path.join(ROOT, "build", "native")
app_main = load_app("cart_pole_py").app_main


def small_cfg(**kw):
    d = dict(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
             nnLayerSizes=[32, 32])
    d.update(kw)
    return HyperParameters(**d)


def _engine(n_envs=2, steps=60, **kw):
    e = smarties_tpu_torch.Engine([], device="cpu")
    e.setNEnvironments(n_envs)
    e.setSettings(small_cfg(**kw))
    e.setNTrainSteps(steps)
    e.setMaxEpisodeLength(256)
    return e


def test_engine_trains_from_app(tmp_path):
    e = _engine()
    e.run_dir = str(tmp_path)
    e.run(app_main, max_wall_s=90)
    assert e.n_grad_steps >= 60
    assert int(e.replay.n_stored_steps()) > 0
    # cumulative-rewards file written in the reference's row format
    rows = np.loadtxt(tmp_path / "agent_00_rank00_cumulative_rewards.dat",
                      ndmin=2)
    assert rows.shape[1] == 5 and rows.shape[0] > 0
    assert set(rows[:, 2].astype(int)) == {0, 1}


def _native(target):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    subprocess.run(["make", "-C", os.path.join(ROOT, "native"),
                    f"BUILD={NATIVE_BUILD}"], check=True,
                   capture_output=True)
    return os.path.join(NATIVE_BUILD, target)


def test_cpp_app_trains():
    from smarties_tpu_torch.runtime.socket_pool import SocketEnvPool
    pool = SocketEnvPool([_native("cart_pole_cpp")], n_envs=2)
    e = _engine(steps=40)
    e.run(None, max_wall_s=90, pool=pool)
    assert e.n_grad_steps >= 40
    assert int(e.replay.n_stored_steps()) > 0


def test_cpp_distrib_agent_team():
    """A 3-process C++ team with distributed agents: one socket per rank,
    rank-0 ingest, identical broadcast replies."""
    from smarties_tpu_torch.runtime.socket_pool import SocketEnvPool
    pool = SocketEnvPool([_native("cart_pole_distribAgent_cpp")], n_envs=2,
                         workers_per_env=3)
    e = _engine(steps=30)
    e.run(None, max_wall_s=120, pool=pool)
    # one logical agent channel per TEAM, not per process
    assert pool.dist_agents and pool.n_channels == 2
    assert pool.n_lanes == 2
    assert e.n_grad_steps >= 30
    assert int(e.replay.n_stored_steps()) > 0


def test_train_restart_eval(tmp_path):
    d = str(tmp_path)
    e = _engine()
    e.run_dir = d
    e.run(app_main, max_wall_s=90)
    ckpt = os.path.join(d, "checkpoint.pt")
    assert os.path.exists(ckpt)
    assert e.n_grad_steps >= 60
    snap = torch.load(ckpt, weights_only=True)
    assert snap["n_grad_steps"] == e.n_grad_steps
    assert snap["learners"][0]["initialized"]

    # restart continues counters and trains further
    e2 = _engine(steps=90)
    e2.setRestartFolderPath(ckpt)
    e2.run(app_main, max_wall_s=90)
    assert e2.n_grad_steps == 90
    assert e2.learners[0].n_env_steps > snap["learners"][0]["n_env_steps"]

    # eval mode: serve deterministically, no grad steps
    e3 = _engine(bTrain=False)
    e3.setRestartFolderPath(ckpt)
    e3.n_eval_episodes = 3
    e3.run(app_main, max_wall_s=90)
    assert e3.n_grad_steps == e.n_grad_steps  # unchanged from checkpoint
    assert os.path.getsize(os.path.join(d, "agent_00_rank00_obs.raw")) > 0


def test_launch_app_script(tmp_path):
    """python -m smarties_tpu_torch.launch apps/cart_pole_py/exec.py
    --device cpu: the script's app_main through the Engine."""
    args = launch.parse_args([
        os.path.join(ROOT, "apps", "cart_pole_py", "exec.py"), "--recipe",
        '{"nnLayerSizes": [16, 16], "batchSize": 16, "minTotObsNum": 128, '
        '"maxTotObsNum": 1024}', "--device", "cpu", "--runprefix",
        str(tmp_path), "--runname", "ext", "--nEnvironments", "2",
        "--nTrainSteps", "30", "--maxEpisodeLength", "256"])
    e = launch.run(args)
    assert type(e).__name__ == "Engine" and e.n_grad_steps >= 30
    run = tmp_path / "ext"
    for f in ("settings.json", "checkpoint.pt",
              "agent_00_rank00_cumulative_rewards.dat"):
        assert (run / f).exists(), f


def test_cma_run_external_moves_to_optimum():
    """What apps/func_maximization's __main__ block runs, on the port:
    CMA over 8 forked apps; the population mean moves toward the optimum
    at 0.4."""
    app = load_app("func_maximization")
    cfg = HyperParameters(learner="CMA", ESpopSize=8, batchSize=4,
                          explNoise=0.0, nnLayerSizes=[8], learnrate=0.05)
    pool = EnvPool(app.app_main, n_envs=8)
    try:
        mdp = pool.probe_spec()
        cma = CMAES(None, mdp, cfg, n_envs=8, max_len=4, device="cpu")
        cma.run_external(pool, n_generations=12, log_every=100,
                         max_wall_s=120)
    finally:
        pool.kill()
    assert cma.n_generations == 12 == int(cma.state.gen)
    avg = [h["avgR"] for h in cma.history]
    assert np.isfinite(avg).all()
    # -sum((x - 0.4)^2): rises toward 0 from the start's about -0.6
    assert np.mean(avg[-3:]) > np.mean(avg[:3]) + 0.1, avg


def test_cma_run_external_generation_parity():
    """One generation of run_external on the same one-step episodes: the
    JAX CMAES from a pinned state, the port from it converted; the
    update's normals of the JAX key chain injected into the port."""
    cfg = dict(learner="CMA", ESpopSize=8, batchSize=2, explNoise=0.0,
               nnLayerSizes=[8], learnrate=0.05)
    pools = [LockstepPool(func_maximization_spec(m.Communicator),
                          [FuncMaximization() for _ in range(8)],
                          m.spec_to_mdp, m.spec_to_mdps)
             for m in (jcomm, tcomm)]
    jc = JCMAES.__new__(JCMAES)
    JCMAES.__init__(jc, None, pools[0].probe_spec(), JHP(**cfg), n_envs=8,
                    max_len=4)
    jc.state = jc.init(jax.random.PRNGKey(3))
    seen = []
    upd = jc._upd_fn

    def recording_update(st, losses, key):
        seen.append((np.asarray(losses), key))
        return upd(st, losses, key)

    jc._upd_fn = recording_update
    tc = CMAES(None, pools[1].probe_spec(), HyperParameters(**cfg),
               n_envs=8, max_len=4, device="cpu")
    tc.state = convert.opt_state_from_jax(jax.device_get(jc.state))
    jc.run_external(pools[0], 1, log_every=100)
    (losses, key), = seen
    z = [torch.as_tensor(np.array(jax.random.normal(
        key, tuple(jc.state.pop.shape), np.float32)))]
    tc.run_external(pools[1], 1, log_every=100, z=z)
    assert tc.n_generations == 1
    want = jax.device_get(jc.state)
    np.testing.assert_allclose(-tc.history[0]["best"], losses.min(),
                               rtol=1e-5, atol=1e-6)
    for k in ("mean", "diag_cov", "path_cov", "pop", "noise"):
        np.testing.assert_allclose(tn(getattr(tc.state, k)),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert int(tc.state.gen) == int(want.gen) == 1

"""Run-directory launcher: built-in environments and user app scripts.

Port of bin/smarties_tpu_launch.py: creates runs/<runname>/, snapshots
the resolved hyperparameters (settings.json) and git provenance
(gitlog.log, gitdiff.log), then either trains a built-in vectorized env
with the recipe's learner and checkpoints the trainer (checkpoint.pt),
or runs a user app script (a path to a file that defines app_main(comm))
through the Engine, which serves it in forked worker processes.

    python -m smarties_tpu_torch.launch cartpole --recipe VRACER \\
        --device cuda --runname r0 --nEnvironments 64 --nTrainSteps 100000
    python -m smarties_tpu_torch.launch cartpole --recipe PPO --device cuda
    python -m smarties_tpu_torch.launch cartpole_pomdp --recipe RACER_RNN \\
        --device cuda --nEnvironments 1024
    python -m smarties_tpu_torch.launch catch --recipe RACER_atari \\
        --device cuda --nEnvironments 1024 --noCheckpoint
    python -m smarties_tpu_torch.launch pendulum --recipe ACER --device cuda
    python -m smarties_tpu_torch.launch glider --recipe RACER_glider \\
        --device cuda --nEnvironments 1024
    python -m smarties_tpu_torch.launch predator_prey --device cuda \\
        --nEnvironments 1024 --logAllSamples   # 512 envs x 2 agents
    python -m smarties_tpu_torch.launch cartpole --recipe CMA --device cuda \\
        --nEnvironments 1020 --nTrainSteps 5     # 5 generations
    python -m smarties_tpu_torch.launch apps/cart_pole_py/exec.py \\
        --nEnvironments 8 --nTrainSteps 20000    # on the card
    python -m smarties_tpu_torch.launch cartpole --nLearners 2 \\
        --device cuda --nEnvironments 1024       # 2 ranks, 2 cards, NCCL
    torchrun --nproc-per-node 4 -m smarties_tpu_torch.launch cartpole \\
        --nLearners 4 --device cuda              # ranks from torchrun

`catch` is the pixel env: its replay stores uint8 frames (65,536 slots of
40 frames of 84x84 at the recipe's maxTotObsNum, 18.5 GB on the card, and
as much in checkpoint.pt unless --noCheckpoint is given).

--device defaults to "cuda" and raises where there is no card: nothing
picks the CPU unless the caller asks for it (--device cpu).

--nLearners K trains one policy with K learner ranks, one process each
(parallel/mesh.py): each owns nEnvironments / K lanes and a K-th of the
replay, and the gradients are summed across ranks. Under torchrun
(WORLD_SIZE set) each process joins the group torchrun made; otherwise
the launcher spawns K local ranks. On "cuda" rank r takes card r and
NCCL, which takes one rank per card; on "cpu" all ranks use gloo.
As in the JAX launcher, CMA and app scripts run one process whatever
--nLearners says.

--recipe takes a name from utils/recipes.py or a settings json (a path
or the json text itself). `run(args)` does the work and returns the Trainer
(the Engine for an app script).
"""
from __future__ import annotations

import argparse
import json
import os
import runpy
import shutil
import subprocess
from typing import Callable, Optional

from smarties_tpu_torch.utils.config import HyperParameters
from smarties_tpu_torch.utils.recipes import RECIPES

# cartpole_pomdp (velocities hidden, the recurrent recipes' task) is the
# port's own app name: the JAX launcher has the env but no name for it
BUILTIN_ENVS = ("cartpole", "cartpole_discrete", "cartpole_pomdp",
                "pendulum", "acrobot", "mountaincar", "catch", "glider",
                "predator_prey")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.launch",
        description="Train a built-in env with a recipe's learner.")
    p.add_argument("app", help="built-in env name (" + ", ".join(BUILTIN_ENVS)
                   + ") or path to an app script defining app_main(comm)")
    p.add_argument("--recipe", default="VRACER",
                   help="recipe name (utils/recipes.py) or settings json")
    p.add_argument("--runname", default="run00")
    p.add_argument("--runprefix", default="runs")
    p.add_argument("--nEnvironments", type=int, default=64)
    p.add_argument("--nTrainSteps", type=int, default=1_000_000)
    p.add_argument("--nLearners", type=int, default=1,
                   help="learner ranks, one process each, training one "
                        "policy on sharded envs and replay (CMA and app "
                        "scripts run one process)")
    p.add_argument("--randSeed", type=int, default=0)
    p.add_argument("--maxEpisodeLength", type=int, default=1024)
    p.add_argument("--logAllSamples", action="store_true",
                   help="write the agent_00_rank00_obs.raw stream of raw "
                        "observations (reference --logAllSamples)")
    p.add_argument("--noCheckpoint", action="store_true",
                   help="do not write checkpoint.pt when training ends "
                        "(it holds the whole replay)")
    p.add_argument("--appSettings", default="",
                   help="comma-separated staged app arg-files "
                        "(reference --appSettings)")
    p.add_argument("--nStepPappSett", default="",
                   help="comma-separated step budget per arg-file stage")
    p.add_argument("--setupFolder", default="",
                   help="folder copied into each per-sim run dir")
    p.add_argument("--simDirs", action="store_true",
                   help="run each env app launch in its own "
                        "simulation_%%03u_%%05u directory")
    p.add_argument("--device", default="cuda",
                   help='torch device, "cuda" (default) or "cpu"')
    return p.parse_args(argv)


def env_module(app: str):
    """The env module (or class) of a built-in app name."""
    if app not in BUILTIN_ENVS:
        raise ValueError(f"app {app!r} is not a built-in env: an app "
                         f"script runs through run(), on the Engine")
    from smarties_tpu_torch.envs import acrobot, cartpole, catch, glider, \
        mountaincar, pendulum, predator_prey
    return {"catch": catch, "cartpole": cartpole,
            "cartpole_discrete": cartpole.discrete,
            "cartpole_pomdp": cartpole.pomdp, "pendulum": pendulum,
            "acrobot": acrobot, "mountaincar": mountaincar,
            "glider": glider, "predator_prey": predator_prey}[app]


def load_recipe(recipe: str, seed: int) -> HyperParameters:
    cfg = (HyperParameters.from_dict(RECIPES[recipe]) if recipe in RECIPES
           else HyperParameters.from_json(recipe))
    cfg.randSeed = seed
    return cfg


def _write_provenance(run_dir: str, cfg: HyperParameters):
    """settings.json, and the git log line and diff stat of the working
    directory (the reference's gitlog.log, README.rst:404)."""
    with open(os.path.join(run_dir, "settings.json"), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    git = shutil.which("git")
    for cmd, fname in ((["log", "-1", "--oneline"], "gitlog.log"),
                       (["diff", "--stat"], "gitdiff.log")):
        out = ("git not found\n" if git is None else subprocess.run(
            [git, *cmd], capture_output=True, text=True, timeout=10).stdout)
        with open(os.path.join(run_dir, fname), "w") as f:
            f.write(out)


def _run_dir(args: argparse.Namespace, cfg: HyperParameters,
             write: bool = True) -> str:
    """runs/<runname>/, created with its provenance where `write` (rank 0
    of a learner mesh)."""
    run_dir = os.path.join(args.runprefix, args.runname)
    if write:
        os.makedirs(run_dir, exist_ok=True)
        _write_provenance(run_dir, cfg)
    return run_dir


def run_app(args: argparse.Namespace):
    """An app script through the Engine (bin/smarties_tpu_launch.py:
    114-130): the script is run with runpy (its `__main__` block does not
    run), its app_main(comm) is served in nEnvironments forked workers
    and trained with the recipe on args.device; --nLearners is not read,
    as in the JAX launcher. Returns the Engine."""
    from smarties_tpu_torch.runtime.engine import Engine
    from smarties_tpu_torch.runtime.trainer import checked_device
    checked_device(args.device)
    app_main = runpy.run_path(args.app)["app_main"]
    cfg = load_recipe(args.recipe, args.randSeed)
    e = Engine([], device=args.device)
    e.setSettings(cfg)
    e.setNEnvironments(args.nEnvironments)
    e.setNTrainSteps(args.nTrainSteps)
    e.setMaxEpisodeLength(args.maxEpisodeLength)
    e.run_dir = _run_dir(args, cfg)
    if args.appSettings:
        e.setSimulationArgumentsFilePath(args.appSettings,
                                         args.nStepPappSett)
    if args.setupFolder:
        e.setSimulationSetupFolderPath(args.setupFolder)
    if args.simDirs:
        e.setUseSimulationDirectories(True)
    e.run(app_main)
    return e


def make_trainer(args: argparse.Namespace, mesh=None):
    """Check the request, write the run directory's provenance and build
    the Trainer (the CMAES for learner CMA, whose lanes are split evenly
    among the population). mesh: this process's learner rank; rank 0
    writes the run directory, and the Trainer runs on mesh.device."""
    env = env_module(args.app)
    cfg = load_recipe(args.recipe, args.randSeed)
    if cfg.learner == "CMA" and args.nEnvironments % cfg.ESpopSize:
        raise ValueError(
            f"learner 'CMA': --nEnvironments {args.nEnvironments} must be a "
            f"multiple of ESpopSize {cfg.ESpopSize} (each env lane runs one "
            f"member of the population)")
    import torch
    from smarties_tpu_torch.runtime.trainer import Trainer, checked_device
    checked_device(args.device)
    run_dir = _run_dir(args, cfg, write=mesh is None or mesh.rank == 0)
    if cfg.learner == "CMA":
        # as the JAX launcher builds it: the default max_len of 512
        from smarties_tpu_torch.algos.cma import CMAES
        return CMAES(env, env.MDP, cfg, n_envs=args.nEnvironments,
                     device=args.device)
    return Trainer(env, env.MDP, cfg, n_envs=args.nEnvironments,
                   max_len=min(args.maxEpisodeLength, env.MAX_STEPS),
                   device=args.device if mesh is None else mesh.device,
                   run_dir=run_dir,
                   state_dtype=torch.uint8 if args.app == "catch" else None,
                   obs_log=args.logAllSamples, mesh=mesh)


def _train(tr, args: argparse.Namespace):
    """Gather minTotObsNum observations (off-policy learners only), take
    nTrainSteps grad steps, save checkpoint.pt (CMA: nTrainSteps
    generations and no checkpoint)."""
    if tr.cfg.learner == "CMA":
        tr.train(args.nTrainSteps)
        return tr
    if not tr.on_policy:
        tr.warmup()
    tr.train(args.nTrainSteps)
    if not args.noCheckpoint:
        tr.save(os.path.join(tr.run_dir, "checkpoint.pt"))
    return tr


def _run_rank(args: argparse.Namespace, prepare=None):
    """One learner rank in an initialised process group: build the
    sharded Trainer on this rank's device (card LOCAL_RANK, or the rank,
    for "cuda") and train it."""
    import torch
    import torch.distributed as dist
    from smarties_tpu_torch.parallel.mesh import make_mesh
    device = args.device
    if torch.device(device).type == "cuda":
        device = f"cuda:{os.environ.get('LOCAL_RANK', dist.get_rank())}"
        torch.cuda.set_device(device)
    mesh = make_mesh(device)
    tr = make_trainer(args, mesh)
    if prepare is not None:
        prepare(tr)
    return _train(tr, args)


def _spawned_rank(rank: int, args: argparse.Namespace, store: str,
                  prepare=None):
    """The body of a rank that `run` spawned: join the group through the
    file store, train, leave the group."""
    import torch
    import torch.distributed as dist
    from smarties_tpu_torch.parallel.multihost import (backend_for,
                                                       init_multihost)
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // args.nLearners))
    init_multihost(store, args.nLearners, rank,
                   backend=backend_for(args.device), timeout_s=120.0)
    try:
        _run_rank(args, prepare)
    finally:
        dist.destroy_process_group()


def run_learners(args: argparse.Namespace, prepare=None):
    """--nLearners K > 1 for a built-in env: join torchrun's group (when
    WORLD_SIZE is set; returns this rank's Trainer) or spawn K local
    ranks (returns None once all have finished; a rank's failure
    raises). K must divide the env lanes; on "cuda", NCCL takes at most
    one rank per card."""
    import tempfile

    import torch.multiprocessing as mp
    from smarties_tpu_torch.parallel.multihost import (backend_for,
                                                       check_ranks,
                                                       init_multihost)
    from smarties_tpu_torch.runtime.trainer import checked_device
    K = args.nLearners
    if args.nEnvironments % K:
        raise ValueError(f"--nLearners {K} must divide --nEnvironments "
                         f"{args.nEnvironments}: each rank owns "
                         f"nEnvironments / nLearners lanes")
    checked_device(args.device)
    backend = backend_for(args.device)
    if "WORLD_SIZE" in os.environ:
        init_multihost(backend=backend)
        return _run_rank(args, prepare)
    check_ranks(backend, K)
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spawned_rank, nprocs=K, join=True, args=(
            args, "file://" + os.path.join(tmp, "store"), prepare))
    return None


def run(args: argparse.Namespace,
        prepare: Optional[Callable] = None):
    """Build the trainer, gather minTotObsNum observations (off-policy
    learners only: an on-policy one fills its own horizon in train()),
    take nTrainSteps grad steps and save runs/<runname>/checkpoint.pt
    (unless args.noCheckpoint). CMA trains nTrainSteps GENERATIONS and
    saves no checkpoint, as the JAX launcher does
    (bin/smarties_tpu_launch.py:100-104).
    prepare(trainer), when given, runs before the warmup (chip_smoke.py
    attaches its launch counters and timers there). Returns the Trainer
    (the CMAES for CMA). An app that is not a built-in env name is an app
    script: `run_app`, which returns the Engine. With --nLearners K > 1
    the built-in env trains on K learner ranks (`run_learners`)."""
    if args.app not in BUILTIN_ENVS:
        return run_app(args)
    if (args.nLearners > 1
            and load_recipe(args.recipe, args.randSeed).learner != "CMA"):
        return run_learners(args, prepare)
    tr = make_trainer(args)
    if prepare is not None:
        prepare(tr)
    return _train(tr, args)


if __name__ == "__main__":
    run(parse_args())

"""Run-directory launcher for the port's built-in environments.

Port of the built-in-env path of bin/smarties_tpu_launch.py: creates
runs/<runname>/, snapshots the resolved hyperparameters (settings.json)
and git provenance (gitlog.log, gitdiff.log), trains a built-in vectorized
env with the recipe's learner on the given device and checkpoints the
trainer (checkpoint.pt).

    python -m smarties_tpu_torch.launch cartpole --recipe VRACER \\
        --device cuda --runname r0 --nEnvironments 64 --nTrainSteps 100000
    python -m smarties_tpu_torch.launch cartpole --recipe PPO --device cuda
    python -m smarties_tpu_torch.launch cartpole_pomdp --recipe RACER_RNN \\
        --device cuda --nEnvironments 1024
    python -m smarties_tpu_torch.launch catch --recipe RACER_atari \\
        --device cuda --nEnvironments 1024 --noCheckpoint

`catch` is the pixel env: its replay stores uint8 frames (65,536 slots of
40 frames of 84x84 at the recipe's maxTotObsNum, 18.5 GB on the card, and
as much in checkpoint.pt unless --noCheckpoint is given).

--device is required: nothing picks the CPU when a card is missing.
--recipe takes a name from utils/recipes.py or a settings json (a path
or the json text itself). `run(args)` does the work and returns the
Trainer.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
from typing import Callable, Optional

from smarties_tpu_torch.utils.config import HyperParameters
from smarties_tpu_torch.utils.recipes import RECIPES

# cartpole_pomdp (velocities hidden, the recurrent recipes' task) is the
# port's own app name: the JAX launcher has the env but no name for it
BUILTIN_ENVS = ("cartpole", "cartpole_discrete", "cartpole_pomdp",
                "pendulum", "acrobot", "mountaincar", "catch")
# built-in apps of the JAX launcher that the port does not have yet
NOT_PORTED_APPS = {"glider": "B10", "predator_prey": "B10"}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.launch",
        description="Train a built-in env with a recipe's learner.")
    p.add_argument("app", help="built-in env name: " + ", ".join(BUILTIN_ENVS))
    p.add_argument("--recipe", default="VRACER",
                   help="recipe name (utils/recipes.py) or settings json")
    p.add_argument("--runname", default="run00")
    p.add_argument("--runprefix", default="runs")
    p.add_argument("--nEnvironments", type=int, default=64)
    p.add_argument("--nTrainSteps", type=int, default=1_000_000)
    p.add_argument("--nLearners", type=int, default=1,
                   help="learner shards (the port runs one)")
    p.add_argument("--randSeed", type=int, default=0)
    p.add_argument("--maxEpisodeLength", type=int, default=1024)
    p.add_argument("--noCheckpoint", action="store_true",
                   help="do not write checkpoint.pt when training ends "
                        "(it holds the whole replay)")
    p.add_argument("--device", required=True,
                   help='torch device, e.g. "cuda" or "cpu"')
    return p.parse_args(argv)


def env_module(app: str):
    """The env module (or class) of a built-in app name."""
    if app in NOT_PORTED_APPS:
        raise NotImplementedError(
            f"app {app!r} is not ported yet (ROADMAP {NOT_PORTED_APPS[app]})")
    if app not in BUILTIN_ENVS:
        raise NotImplementedError(
            f"app {app!r}: external app scripts run through the Engine, "
            f"which is not ported yet (ROADMAP B11)")
    from smarties_tpu_torch.envs import acrobot, cartpole, catch, \
        mountaincar, pendulum
    return {"catch": catch, "cartpole": cartpole, "cartpole_discrete": cartpole.discrete,
            "cartpole_pomdp": cartpole.pomdp, "pendulum": pendulum,
            "acrobot": acrobot, "mountaincar": mountaincar}[app]


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


def make_trainer(args: argparse.Namespace):
    """Check the request, write the run directory's provenance and build
    the Trainer. Raises NotImplementedError, naming the ROADMAP item, for
    what the port does not have yet."""
    if args.nLearners > 1:
        raise NotImplementedError(
            "--nLearners > 1: multi-device learners are not ported yet "
            "(ROADMAP B12)")
    env = env_module(args.app)
    cfg = load_recipe(args.recipe, args.randSeed)
    if cfg.learner == "CMA":
        raise NotImplementedError(
            "learner 'CMA' is gradient-free and not ported yet (ROADMAP B8)")
    import torch
    from smarties_tpu_torch.runtime.trainer import Trainer
    run_dir = os.path.join(args.runprefix, args.runname)
    os.makedirs(run_dir, exist_ok=True)
    _write_provenance(run_dir, cfg)
    return Trainer(env, env.MDP, cfg, n_envs=args.nEnvironments,
                   max_len=min(args.maxEpisodeLength, env.MAX_STEPS),
                   device=args.device, run_dir=run_dir,
                   state_dtype=torch.uint8 if args.app == "catch" else None)


def run(args: argparse.Namespace,
        prepare: Optional[Callable] = None):
    """Build the trainer, gather minTotObsNum observations (off-policy
    learners only: an on-policy one fills its own horizon in train()),
    take nTrainSteps grad steps and save runs/<runname>/checkpoint.pt
    (unless args.noCheckpoint).
    prepare(trainer), when given, runs before the warmup (chip_smoke.py
    attaches its launch counters and timers there). Returns the Trainer."""
    tr = make_trainer(args)
    if prepare is not None:
        prepare(tr)
    if not tr.on_policy:
        tr.warmup()
    tr.train(args.nTrainSteps)
    if not args.noCheckpoint:
        tr.save(os.path.join(tr.run_dir, "checkpoint.pt"))
    return tr


if __name__ == "__main__":
    run(parse_args())

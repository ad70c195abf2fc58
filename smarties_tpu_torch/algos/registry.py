"""Learner factory: settings string -> algorithm instance.

Port of smarties_tpu/algos/registry.py (reference AlgoFactory,
Learners/AlgoFactory.cpp:60-340) for the learners the port has: V-RACER.
Every other name raises until its learner is ported.
"""
from __future__ import annotations

from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.utils.config import HyperParameters


def make_learner(mdp: MDPSpec, cfg: HyperParameters):
    name = cfg.learner
    if name in ("VRACER", "default") and cfg.ESpopSize <= 1:
        from smarties_tpu_torch.algos.vracer import VRacer
        return VRacer(mdp, cfg)
    raise NotImplementedError(
        f"learner {name!r} (ESpopSize {cfg.ESpopSize}) is not ported to "
        f"torch yet; smarties_tpu_torch runs V-RACER")

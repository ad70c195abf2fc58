"""Learner factory: settings string -> algorithm instance.

Port of smarties_tpu/algos/registry.py (reference AlgoFactory,
Learners/AlgoFactory.cpp:60-340) for the learners the port has: the RACER
family (V-RACER, RACER, RACER-discrete), DQN/NFQ, NAF, DPG/DDPG,
MixedPG and PPO. The others raise NotImplementedError naming their
ROADMAP item.
"""
from __future__ import annotations

from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.utils.config import HyperParameters


def make_learner(mdp: MDPSpec, cfg: HyperParameters):
    name = cfg.learner
    if name in ("VRACER", "default", "RACER"):
        if cfg.ESpopSize > 1:
            raise NotImplementedError(
                f"learner {name!r} with ESpopSize {cfg.ESpopSize} is "
                f"RACER-ES, not ported yet (ROADMAP B8)")
        from smarties_tpu_torch.algos.vracer import Racer, VRacer
        # V-RACER on a discrete MDP auto-rewrites to RACER-discrete
        return Racer(mdp, cfg) if name == "RACER" else VRacer(mdp, cfg)
    if name in ("DQN", "NFQ"):
        from smarties_tpu_torch.algos.dqn import DQN
        return DQN(mdp, cfg)
    if name == "NAF":
        from smarties_tpu_torch.algos.naf import NAF
        return NAF(mdp, cfg)
    if name in ("DPG", "DDPG"):
        from smarties_tpu_torch.algos.dpg import DPG
        return DPG(mdp, cfg)
    if name == "MixedPG":
        from smarties_tpu_torch.algos.mixedpg import MixedPG
        return MixedPG(mdp, cfg)
    if name in ("PPO", "GAE"):
        from smarties_tpu_torch.algos.ppo import PPO
        return PPO(mdp, cfg)
    if name == "ACER":
        if mdp.is_discrete:
            raise ValueError(
                "learner 'ACER' supports continuous action spaces only "
                "(reference parity); use RACER/DQN for discrete MDPs")
        raise NotImplementedError(
            "learner 'ACER' is not ported yet (ROADMAP B7)")
    if name == "CMA":
        raise NotImplementedError(
            "learner 'CMA' is gradient-free and not ported yet (ROADMAP B8)")
    raise ValueError(f"unknown learner '{name}'")

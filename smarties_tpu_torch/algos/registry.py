"""Learner factory: settings string -> algorithm instance.

Port of smarties_tpu/algos/registry.py (reference AlgoFactory,
Learners/AlgoFactory.cpp:60-340): the RACER family (V-RACER, RACER,
RACER-discrete; RACER-ES when ESpopSize > 1), DQN/NFQ, NAF, DPG/DDPG,
MixedPG, PPO and ACER. CMA drives its own rollouts and is built as
algos/cma.CMAES instead.
"""
from __future__ import annotations

from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.utils.config import HyperParameters


def make_learner(mdp: MDPSpec, cfg: HyperParameters):
    name = cfg.learner
    if name in ("VRACER", "default", "RACER"):
        if cfg.ESpopSize > 1:
            # the derivative-free path (VRACER_CMA)
            from smarties_tpu_torch.algos.racer_es import RacerES
            if name == "RACER":
                return RacerES(mdp, cfg, adv_kind="discrete"
                               if mdp.is_discrete else "gaussian")
            return RacerES(mdp, cfg)
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
        from smarties_tpu_torch.algos.acer import ACER
        return ACER(mdp, cfg)
    if name == "CMA":
        raise ValueError(
            "CMA is gradient-free and drives its own rollouts: use "
            "smarties_tpu_torch.algos.cma.CMAES(env, mdp, cfg, device=...) "
            "directly")
    raise ValueError(f"unknown learner '{name}'")

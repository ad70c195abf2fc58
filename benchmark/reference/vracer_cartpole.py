"""Plain reference of the configuration vracer_cartpole: V-RACER (A = 0,
a tanh-squashed Gaussian policy with a trainable stdev head) over a
[128, 128] SoftSign net on cart-pole's observed state [x, v, omega,
cos(angle), sin(angle)]; actions in [-10, 10] N as 10 tanh(a)."""
from __future__ import annotations

import torch

from benchmark.reference import cartpole, nets, racer

KIND = "continuous"
ENV_GAP = "env_state"
N_ACT = 1


def arch(config: dict) -> dict:
    s = config["settings"]
    return {"n_in": 5, "hidden": s["nnLayerSizes"], "n_out": 1 + N_ACT,
            "n_param": N_ACT, "act": s.get("nnFunc", "SoftSign"),
            "out_prefac": s.get("outWeightsPrefac", 0.1)}


def param_init(config: dict) -> float:
    return racer.softplus_inv(config["settings"]["explNoise"])


def net_input(frames, mean, scale):
    """frames [B, 1, 5] raw stored states -> standardized [B, 5]."""
    return ((frames.to(mean.dtype) - mean) * scale)[:, 0]


def batch_extras(mb: dict) -> dict:
    return {"bounded": torch.ones(N_ACT, dtype=torch.bool,
                                  device=mb["qret"].device)}


def env_gaps(cols: dict):
    """(largest state gap, wrong rewards or ends) of stored episodes."""
    return cartpole.transition_gaps(cols["states"], cols["actions"],
                                    cols["rewards"], cols["length"],
                                    cols["terminal"])


forward = nets.forward

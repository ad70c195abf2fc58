"""The configurations' networks in plain PyTorch, dense weights [in,
out].

smarties' feed-forward net (Network/Builder.cpp): hidden layers act(x W
+ b), a linear output layer, and for continuous policies a trainable
state-independent stdev head appended to the outputs. Weights are drawn
U(-f, f): Glorot f = sqrt(6 / (in + out)) for SoftSign and Tanh layers,
He f = sqrt(2 / fan_in) otherwise, and the output layer
outWeightsPrefac * sqrt(1 / in); biases are zero.
"""
from __future__ import annotations

import math

import torch

ACTS = {"SoftSign": lambda x: x / (1 + torch.abs(x)), "Tanh": torch.tanh}
GLOROT = {"SoftSign", "Tanh"}


def leaf_shapes(arch: dict) -> list:
    """[(name, shape, init bound)] of every leaf, in draw order.
    arch: n_in, hidden, n_out, n_param, act, out_prefac."""
    out = []
    sizes = [arch["n_in"]] + list(arch["hidden"])
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        f = (math.sqrt(6.0 / (a + b)) if arch["act"] in GLOROT
             else math.sqrt(2.0 / a))
        out += [(f"dense{i}.W", (a, b), f), (f"dense{i}.b", (b,), 0.0)]
    out += [("out.W", (sizes[-1], arch["n_out"]),
             arch["out_prefac"] * math.sqrt(1.0 / sizes[-1])),
            ("out.b", (arch["n_out"],), 0.0)]
    return out


def draw_weights(gen: torch.Generator, arch: dict, param_init=None,
                 device=None) -> dict:
    """Every weight from one uniform draw on the device, in f32:
    {name: tensor}. param_init: the stdev head's initial raw values."""
    shapes = leaf_shapes(arch)
    n = sum(math.prod(s) for _, s, f in shapes if f > 0)
    u = torch.rand((n,), generator=gen, device=device) * 2 - 1
    w, k = {}, 0
    for name, shape, f in shapes:
        if f > 0:
            m = math.prod(shape)
            w[name] = (u[k:k + m] * f).reshape(shape)
            k += m
        else:
            w[name] = torch.zeros(shape, device=device)
    if arch.get("n_param"):
        w["param"] = torch.full((arch["n_param"],), float(param_init),
                                device=device)
    return w


def forward(w: dict, arch: dict, x):
    """Net outputs [B, n_out + n_param] for standardized inputs x [B,
    n_in]."""
    h = x
    act = ACTS[arch["act"]]
    for i in range(len(arch["hidden"])):
        h = act(h @ w[f"dense{i}.W"] + w[f"dense{i}.b"])
    y = h @ w["out.W"] + w["out.b"]
    if "param" in w:
        y = torch.cat([y, w["param"].expand(y.shape[0], -1)], dim=-1)
    return y

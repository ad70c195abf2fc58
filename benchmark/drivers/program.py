"""The seam between the benchmark and the program: building the port's
Trainer from a configuration file, and moving weights between the
reference's names and the program's parameter tree. Dense weights are
[in, out] on both sides; a configuration whose layouts differ (a conv
stack) gives its reference module to_program(name, x) and
from_program(name, x)."""
from __future__ import annotations

import importlib

import torch


def settings(files: dict, sizes: dict | None = None) -> dict:
    s = {**files["config"]["settings"], **files["mix"].get("settings", {})}
    s.update((sizes or {}).get("settings", {}))
    return s


def build_trainer(files: dict, seed: int, device, sizes=None, graphs=None):
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters
    conf = {**files["config"], **(sizes or {})}
    env = importlib.import_module("smarties_tpu_torch.envs." + conf["env"])
    cfg = HyperParameters.from_dict({**settings(files, sizes),
                                     "randSeed": seed})
    return Trainer(env, env.MDP, cfg, n_envs=conf["n_envs"],
                   n_slots=conf["n_slots"], max_len=conf["max_len"],
                   device=device, state_dtype=getattr(torch, conf["state_dtype"]),
                   graphs=graphs)


def program_leaves(params) -> dict:
    """{reference name: program leaf}."""
    out = {}
    for i, layer in enumerate(params["layers"]):
        out[f"dense{i}.W"], out[f"dense{i}.b"] = layer["W"], layer["b"]
    out["out.W"], out["out.b"] = params["out"]["W"], params["out"]["b"]
    if "param" in params:
        out["param"] = params["param"]
    for i, layer in enumerate(params.get("conv", [])):
        out[f"conv{i}.W"], out[f"conv{i}.b"] = layer["W"], layer["b"]
    return out


def _same(name, x):
    return x


@torch.no_grad()
def write_weights(params, w: dict, ref):
    to_program = getattr(ref, "to_program", _same)
    for name, leaf in program_leaves(params).items():
        leaf.copy_(to_program(name, w[name]))


def read_tree(tree, ref, scale: float = 1.0) -> dict:
    """A tree shaped like the params (weights or an Adam moment) in the
    reference's names and layouts, copied."""
    from_program = getattr(ref, "from_program", _same)
    return {n: from_program(n, x.detach()).clone() * scale
            for n, x in program_leaves(tree).items()}


@torch.no_grad()
def reset_adam(opt):
    """The optimiser state of a fresh start, in place."""
    for tree in (opt.m1, opt.m2):
        for x in program_leaves(tree).values():
            x.zero_()
    opt.beta_t_1.fill_(0.9)
    opt.beta_t_2.fill_(0.999)
    opt.step.zero_()

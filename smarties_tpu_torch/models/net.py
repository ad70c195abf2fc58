"""Function approximator: the feed-forward MLP with a param head.

Port of the FFNN path of smarties_tpu/models/net.py (reference:
Network/{Network,Builder}.{h,cpp}, Layers/*). The parameters are a plain
dict of leaf tensors with the JAX package's structure and layouts —
{"layers": [{"W": [in, out], "b": [out]}, ...], "out": {"W", "b"},
"param": [n_param_out]} — so models/convert.py maps one to the other
without reshaping, and `apply_net` computes x @ W + b as the JAX code
does. Leaves require grad; the learner pulls output gradients back with
autograd and updates the leaves in place (models/optim.py).

Init conventions follow the reference exactly:
- weights ~ U(-f, f), f = act.initFactor(nIn, nOut) (Layer_Base.h:115-141,
  Functions.h: SoftSign/Tanh sqrt(6/(in+out)), Relu/SoftPlus/Exp
  sqrt(2/in), Linear sqrt(1/in));
- biases zero, except the output bias set through the activation inverse
  (Layer_Base.h:122-125);
- the output layer is Linear, its init scaled by outWeightsPrefac;
- a trainable state-independent param head appends extra outputs (the
  policy stdev, RACER_common.cpp:96-103).

Conv stacks, recurrent layers (RNN/LSTM/GRU) and residual links are not
ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch


# ---------------- activations (Functions.h) ----------------

_ACTS = {
    "Linear": lambda x: x,
    "Tanh": torch.tanh,
    "Sigm": torch.sigmoid,
    "SoftSign": lambda x: x / (1 + torch.abs(x)),
    "Relu": torch.relu,
    "LRelu": lambda x: torch.where(x > 0, x, 0.01 * x),
    "SoftPlus": lambda x: (x + torch.sqrt(1 + x * x)) / 2,
    "Exp": torch.exp,
    "HardSign": lambda x: x / torch.sqrt(1 + x * x),
    "HardSigmoid": lambda x: 0.5 * (1 + x / torch.sqrt(1 + x * x)),
    "SoftRBF": lambda x: 1.0 / (1 + x * x),
    "ExpPlus": lambda x: torch.log1p(torch.exp(torch.clamp(x, -32.0, 16.0))),
}

_INIT_FACTOR = {
    "Linear": lambda i, o: np.sqrt(1.0 / i),
    "Tanh": lambda i, o: np.sqrt(6.0 / (i + o)),
    "Sigm": lambda i, o: np.sqrt(6.0 / (i + o)),
    "SoftSign": lambda i, o: np.sqrt(6.0 / (i + o)),
    "HardSign": lambda i, o: np.sqrt(6.0 / (i + o)),
    "HardSigmoid": lambda i, o: np.sqrt(6.0 / (i + o)),
    "SoftRBF": lambda i, o: np.sqrt(6.0 / (i + o)),
    "Relu": lambda i, o: np.sqrt(2.0 / i),
    "LRelu": lambda i, o: np.sqrt(1.0 / i),
    "SoftPlus": lambda i, o: np.sqrt(2.0 / i),
    "ExpPlus": lambda i, o: np.sqrt(2.0 / i),
    "Exp": lambda i, o: np.sqrt(2.0 / i),
}

# activation inverses for the output-bias init (Layer_Base.h:122-125)
_INVERSE = {
    "Linear": lambda y: y,
    "Tanh": np.arctanh,
    "Sigm": lambda y: np.log(y / (1 - y)),
    "SoftSign": lambda y: y / (1 - np.abs(y)),
    "HardSign": lambda y: y / np.sqrt(1 - y * y),
    "HardSigmoid": lambda y: (2 * y - 1) / np.sqrt(1 - (2 * y - 1) ** 2),
    "SoftPlus": lambda y: y - 1.0 / (4 * y),
    "ExpPlus": lambda y: np.log(np.exp(y) - 1),
    "Exp": np.log,
    "Relu": lambda y: y,
    "LRelu": lambda y: y,
    "SoftRBF": lambda y: np.sqrt(1.0 / y - 1.0),
}


@dataclass(frozen=True)
class NetSpec:
    """Static architecture description (Builder.cpp:27-180); the same
    fields as the JAX package's NetSpec for the FFNN path."""
    n_in: int
    hidden: Tuple[int, ...] = (128, 128)
    n_out: int = 1
    kind: str = "FFNN"              # nnType; only FFNN is ported
    act: str = "SoftSign"           # nnFunc
    out_act: str = "Linear"         # nnOutputFunc
    out_prefac: float = 0.1         # outWeightsPrefac
    n_param_out: int = 0            # trainable param head size (stdev)
    param_init: Tuple[float, ...] = ()
    out_bias_init: Tuple[float, ...] = ()

    @property
    def total_out(self) -> int:
        return self.n_out + self.n_param_out


# ---------------- parameter trees ----------------

def tree_map(fn, tree, *rest):
    """Map `fn` over the leaves of nested dicts/lists (dict keys in sorted
    order, the order of jax.tree_util)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of nested dicts/lists in jax.tree_util.tree_leaves order."""
    out = []
    tree_map(out.append, tree)
    return out


def _check_ffnn(spec: NetSpec):
    if spec.kind != "FFNN":
        raise NotImplementedError(
            f"nnType {spec.kind!r}: only FFNN is ported to torch so far")


def init_params(gen: Optional[torch.Generator], spec: NetSpec,
                device=None) -> Dict:
    """Build the parameter dict; U(-f, f) draws come from `gen` (a CPU
    generator keeps the init identical on every device)."""
    _check_ffnn(spec)

    def uniform(shape, fac):
        w = torch.empty(shape, dtype=torch.float32)
        return w.uniform_(-float(fac), float(fac), generator=gen)

    sizes = [spec.n_in] + list(spec.hidden)
    params = {"layers": [], "out": {}}
    for nin, nout in zip(sizes[:-1], sizes[1:]):
        params["layers"].append({
            "W": uniform((nin, nout), _INIT_FACTOR[spec.act](nin, nout)),
            "b": torch.zeros((nout,), dtype=torch.float32)})
    nin = sizes[-1]
    fac = spec.out_prefac * _INIT_FACTOR[spec.out_act](nin, spec.n_out)
    bias = torch.zeros((spec.n_out,), dtype=torch.float32)
    if spec.out_bias_init:
        inv = _INVERSE[spec.out_act](np.asarray(spec.out_bias_init,
                                                np.float64))
        bias = torch.as_tensor(inv, dtype=torch.float32)
    params["out"] = {"W": uniform((nin, spec.n_out), fac), "b": bias}
    if spec.n_param_out:
        params["param"] = (
            torch.as_tensor(spec.param_init, dtype=torch.float32)
            if spec.param_init else
            torch.zeros((spec.n_param_out,), dtype=torch.float32))
    return tree_map(lambda x: x.to(device).requires_grad_(True), params)


def apply_net(params: Dict, spec: NetSpec, x, carry=()):
    """Forward pass. x: [..., n_in] -> (y [..., total_out], carry)."""
    _check_ffnn(spec)
    act = _ACTS[spec.act]
    h = x
    for layer in params["layers"]:
        h = act(h @ layer["W"] + layer["b"])
    y = _ACTS[spec.out_act](h @ params["out"]["W"] + params["out"]["b"])
    if spec.n_param_out:
        p = params["param"].expand(tuple(y.shape[:-1])
                                   + (spec.n_param_out,))
        y = torch.cat([y, p], dim=-1)
    return y, ()

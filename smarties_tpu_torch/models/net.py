"""Function approximators: MLP / RNN / LSTM / GRU stacks with a param head
and an optional conv preprocessing stack.

Port of smarties_tpu/models/net.py (reference:
Network/{Network,Builder}.{h,cpp}, Layers/*). The parameters are a plain
dict of leaf tensors with the JAX package's structure, leaf names and
[in, out] layouts — {"layers": [layer, ...], "out": {"W", "b"}, "param":
[n_param_out]} — so models/convert.py maps one to the other without
reshaping, and `apply_net` computes x @ W + b as the JAX code does.
Leaves require grad; the learner pulls output gradients back with
autograd and updates the leaves in place (models/optim.py).

A layer is, by `NetSpec.kind`:
- FFNN: {"W", "b"}, h = act(x W + b), with `residual` summing the input
  back in where the widths match (ResidualLayer, Layers.h:421-470);
- RNN:  {"W", "R", "b"}, h = act(x W + hprev R + b);
- LSTM (Layer_LSTM.h): separate leaves per gate, {"Wc Wi Wf Wo", "Rc Ri
  Rf Ro", "bc bi bf bo"}: c = sigm(f) cprev + sigm(i) tanh(c~),
  h = sigm(o) tanh(c); the forget bias starts at 1;
- GRU: the minimal gated unit of Layer_GRU.h, {"Wf Rf Wh Rh bf bh"}:
  f = sigm(x Wf + hprev Rf + bf), h~ = tanh(x Wh + (f hprev) Rh + bh),
  h = (1 - f) hprev + f h~.
The cells are plain tensor ops written as the JAX cell is written, gate
by gate (torch.nn.LSTM / GRU have another gate layout, fused biases and
the standard GRU, so their leaves would not map 1:1). The recurrent
carry is a tuple with one entry per hidden layer: a tensor, or the pair
(h, c) for an LSTM layer. Truncated BPTT is a Python loop over
`apply_net` under autograd (`apply_net_seq`, algos/base.py::seq_outputs),
except for the LSTM windows on the card that ops/lstm_window_kernel.py
runs, whose output layer is `apply_out`.

Init conventions follow the reference exactly:
- weights ~ U(-f, f), f = act.initFactor(nIn, nOut) (Layer_Base.h:115-141,
  Functions.h: SoftSign/Tanh sqrt(6/(in+out)), Relu/SoftPlus/Exp
  sqrt(2/in), Linear sqrt(1/in));
- biases zero, except the output bias set through the activation inverse
  (Layer_Base.h:122-125);
- the output layer is Linear, its init scaled by outWeightsPrefac;
- a trainable state-independent param head appends extra outputs (the
  policy stdev, RACER_common.cpp:96-103).

A conv stack (`NetSpec.conv`; addConv2d, Conv2Dfactory.h) sits before the
dense layers: params["conv"][i] = {"W": [K, K, Cin, O], "b": [O]}, the JAX
package's HWIO layout, so convert stays a plain copy. The flat input is
[frame_t; frame_t-1; ...] (appended past observations), i.e. CHW with the
frames as channels; the convs are VALID with square filters and strides,
each followed by bias and LRelu, and the output is flattened in (h, w, c)
order as the JAX package's NHWC conv flattens it, so the first dense
layer's rows mean the same in both. The conv itself is
torch.nn.functional.conv2d (cuDNN on the card), run channels_last there.
The JAX package's space-to-depth rewrite of the first layer is a layout
transform for another device and computes the same sums: not ported.

`NetSpec.compute_dtype = "bfloat16"` (the settings' nnBf16) runs the
dense and conv contractions as the JAX package runs them: both operands
cast to bf16, the product accumulated in f32 and rounded to bf16, then
cast back to f32. That covers the FFNN layers, the output layer and the
convs (the input is cast before its reshape; each conv's bias is added
in f32 after the upcast). The recurrent cells' products, the parameter
head, the bias adds, the activations and the residual sums stay f32, and
the leaves stay f32: autograd through the casts gives the JAX VJP, whose
cotangents are cast to bf16 for the transposed products and back.
"""
from __future__ import annotations

import dataclasses
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


def join(*xs):
    """JoinLayer analog (Layers.h JoinLayer): input streams concatenated
    on the feature axis (e.g. the DPG critic's action input)."""
    return torch.cat(xs, dim=-1)


@dataclass(frozen=True)
class Conv2DDesc:
    """One conv layer (Conv2D_Descriptor, Definitions.h:60-69, set by
    Communicator::setPreprocessingConv2d). Valid padding, square filters
    and strides, as in the reference Conv2DLayer."""
    in_w: int
    in_h: int
    in_c: int
    out_c: int
    filter: int
    stride: int

    @property
    def out_w(self) -> int:
        return (self.in_w - self.filter) // self.stride + 1

    @property
    def out_h(self) -> int:
        return (self.in_h - self.filter) // self.stride + 1


@dataclass(frozen=True)
class NetSpec:
    """Static architecture description (Builder.cpp:27-180); the fields
    of the JAX package's NetSpec."""
    n_in: int
    hidden: Tuple[int, ...] = (128, 128)
    n_out: int = 1
    kind: str = "FFNN"              # nnType: FFNN | RNN | LSTM | GRU
    act: str = "SoftSign"           # nnFunc
    out_act: str = "Linear"         # nnOutputFunc
    out_prefac: float = 0.1         # outWeightsPrefac
    n_param_out: int = 0            # trainable param head size (stdev)
    param_init: Tuple[float, ...] = ()
    out_bias_init: Tuple[float, ...] = ()
    # skip connections between equal-width FFNN hidden layers
    residual: bool = False
    # conv preprocessing stack applied to the (flattened-image) input
    # before the dense layers (addConv2d, Conv2Dfactory.h)
    conv: Tuple[Conv2DDesc, ...] = ()
    # "bfloat16": the dense and conv contractions in bf16 with f32
    # accumulation (see the module docstring); "float32" throughout else
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.kind not in ("FFNN", "RNN", "LSTM", "GRU"):
            raise ValueError(f"nnType {self.kind!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {self.compute_dtype!r}")

    @property
    def total_out(self) -> int:
        return self.n_out + self.n_param_out

    @property
    def is_recurrent(self) -> bool:
        return self.kind in ("LSTM", "GRU", "RNN")


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


@torch.no_grad()
def tree_copy_(dst, src):
    """Copy every tensor of `src` into the tensor at the same place of
    `dst`, which keeps its storage; returns dst. Trees of dicts, lists,
    tuples, named tuples and dataclasses (the replay state); a tensor
    that is already dst's is skipped, and so are the leaves that are not
    tensors (generators)."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            tree_copy_(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src, strict=True):
            tree_copy_(d, s)
    elif dataclasses.is_dataclass(dst):
        for f in dataclasses.fields(dst):
            tree_copy_(getattr(dst, f.name), getattr(src, f.name))
    return dst


def tree_leaves(tree) -> list:
    """Leaves of nested dicts/lists in jax.tree_util.tree_leaves order."""
    out = []
    tree_map(out.append, tree)
    return out


def _mlp_in_dim(spec: NetSpec) -> int:
    """Dense-stack input size: the conv output if there is a conv stack."""
    if spec.conv:
        c = spec.conv[-1]
        return c.out_w * c.out_h * c.out_c
    return spec.n_in


def init_params(gen: Optional[torch.Generator], spec: NetSpec,
                device=None) -> Dict:
    """Build the parameter dict; U(-f, f) draws come from `gen` (a CPU
    generator keeps the init identical on every device)."""

    def uniform(shape, fac):
        w = torch.empty(shape, dtype=torch.float32)
        return w.uniform_(-float(fac), float(fac), generator=gen)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32)

    sizes = [_mlp_in_dim(spec)] + list(spec.hidden)
    params = {"layers": [], "out": {}}
    for nin, nout in zip(sizes[:-1], sizes[1:]):
        if spec.kind in ("FFNN", "RNN"):
            fac = _INIT_FACTOR[spec.act](nin, nout)
            layer = {"W": uniform((nin, nout), fac), "b": zeros(nout)}
            if spec.kind == "RNN":
                layer["R"] = uniform((nout, nout), fac)
        else:
            # glorot per gate: the cell input is Tanh-like, the gates
            # sigmoids (Layer_LSTM.h, Layer_GRU.h)
            fac = {"c": _INIT_FACTOR["Tanh"](nin, nout),
                   "g": _INIT_FACTOR["Sigm"](nin, nout)}
            gates = ({"c": "c", "i": "g", "f": "g", "o": "g"}
                     if spec.kind == "LSTM" else {"f": "g", "h": "c"})
            layer = {}
            for g, k in gates.items():
                layer["W" + g] = uniform((nin, nout), fac[k])
            for g, k in gates.items():
                layer["R" + g] = uniform((nout, nout), fac[k])
            for g in gates:
                layer["b" + g] = zeros(nout)
            if spec.kind == "LSTM":
                # forget-gate bias primed to 1 (the reference zeroes it
                # only in finite-difference test builds, Bund.h:62-67)
                layer["bf"] = torch.ones((nout,), dtype=torch.float32)
        params["layers"].append(layer)
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
    if spec.conv:
        # drawn after the dense leaves, so a dense net's init does not
        # depend on whether another net has a conv stack
        params["conv"] = []
        for c in spec.conv:
            fac = _INIT_FACTOR["Relu"](c.filter * c.filter * c.in_c,
                                       c.out_c)
            params["conv"].append({
                "W": uniform((c.filter, c.filter, c.in_c, c.out_c), fac),
                "b": zeros(c.out_c)})
    return tree_map(lambda x: x.to(device).requires_grad_(True), params)


def init_carry(spec: NetSpec, batch_shape=(), device=None,
               dtype=torch.float32):
    """Zero recurrent state (AgentContext analog, ThreadContext.h): () for
    a feed-forward net, else one entry per hidden layer, [*batch, h], an
    (h, c) pair for LSTM layers."""
    if not spec.is_recurrent:
        return ()

    def z(h):
        return torch.zeros(tuple(batch_shape) + (h,), dtype=dtype,
                           device=device)

    return tuple((z(h), z(h)) if spec.kind == "LSTM" else z(h)
                 for h in spec.hidden)


def _mm(a, w, bf16: bool):
    """a @ w; in bf16 with the result rounded to bf16 and cast back, as
    the JAX package's `mm` computes it."""
    if not bf16:
        return a @ w
    return (a.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()


def _conv_stack(layers, conv: Tuple[Conv2DDesc, ...], x, bf16: bool,
                boundary=None):
    """[..., C*H*W] flat CHW input -> [..., h*w*c] features, flattened in
    (h, w, c) order. boundary(features, macs) -> features, if given: the
    output passes through it on its way to the dense layers, with the
    multiply-adds each conv ran, from the shapes it saw."""
    conv2d = torch.nn.functional.conv2d
    c0 = conv[0]
    lead = x.shape[:-1]
    if bf16:
        x = x.to(torch.bfloat16)
    h = x.reshape((-1, c0.in_c, c0.in_h, c0.in_w))
    if h.is_cuda:
        h = h.contiguous(memory_format=torch.channels_last)
    macs = []
    for layer, c in zip(layers, conv):
        # leaves are HWIO; conv2d takes OIHW
        w = layer["W"].permute(3, 2, 0, 1)
        if bf16:
            # the bias joins in f32, after the upcast
            h = (conv2d(h.to(torch.bfloat16), w.to(torch.bfloat16),
                        stride=c.stride).float()
                 + layer["b"][:, None, None])
        else:
            h = conv2d(h, w, layer["b"], stride=c.stride)
        # an output element is a sum over the filter's window and channels
        macs.append(h.numel() * w.shape[1] * w.shape[2] * w.shape[3])
        h = _ACTS["LRelu"](h)
    # a view where h is channels_last
    out = h.permute(0, 2, 3, 1).reshape(lead + (-1,))
    return out if boundary is None else boundary(out, tuple(macs))


def apply_net(params: Dict, spec: NetSpec, x, carry=(), conv_boundary=None):
    """Forward pass. x: [..., n_in] -> (y [..., total_out], new_carry).

    Batched over leading axes; a recurrent carry (see init_carry) must
    share those axes. Feed-forward nets return (). conv_boundary: see
    _conv_stack (a traced step's phase marks)."""
    act = _ACTS[spec.act]
    bf16 = spec.compute_dtype == "bfloat16"
    h = x
    if spec.conv:
        h = _conv_stack(params["conv"], spec.conv, h, bf16, conv_boundary)
    new_carry = []
    for li, layer in enumerate(params["layers"]):
        if spec.kind == "FFNN":
            h_new = act(_mm(h, layer["W"], bf16) + layer["b"])
            if spec.residual and h_new.shape[-1] == h.shape[-1]:
                h_new = h_new + h
            h = h_new
        elif spec.kind == "RNN":
            h = act(h @ layer["W"] + carry[li] @ layer["R"] + layer["b"])
            new_carry.append(h)
        elif spec.kind == "LSTM":
            hprev, cprev = carry[li]
            zc = torch.tanh(h @ layer["Wc"] + hprev @ layer["Rc"]
                            + layer["bc"])
            zi = torch.sigmoid(h @ layer["Wi"] + hprev @ layer["Ri"]
                               + layer["bi"])
            zf = torch.sigmoid(h @ layer["Wf"] + hprev @ layer["Rf"]
                               + layer["bf"])
            zo = torch.sigmoid(h @ layer["Wo"] + hprev @ layer["Ro"]
                               + layer["bo"])
            c = zf * cprev + zi * zc
            h = zo * torch.tanh(c)
            new_carry.append((h, c))
        else:   # GRU: the minimal gated unit
            hprev = carry[li]
            f = torch.sigmoid(h @ layer["Wf"] + hprev @ layer["Rf"]
                              + layer["bf"])
            hh = torch.tanh(h @ layer["Wh"] + (f * hprev) @ layer["Rh"]
                            + layer["bh"])
            h = (1 - f) * hprev + f * hh
            new_carry.append(h)
    return apply_out(params, spec, h), tuple(new_carry)


def apply_out(params: Dict, spec: NetSpec, h):
    """The output layer and the param head: the last hidden layer's h
    [..., hidden[-1]] -> y [..., total_out]."""
    bf16 = spec.compute_dtype == "bfloat16"
    y = _ACTS[spec.out_act](_mm(h, params["out"]["W"], bf16)
                            + params["out"]["b"])
    if spec.n_param_out:
        p = params["param"].expand(tuple(y.shape[:-1])
                                   + (spec.n_param_out,))
        y = torch.cat([y, p], dim=-1)
    return y


def apply_net_seq(params: Dict, spec: NetSpec, xs, carry):
    """Run a time sequence (the BPTT path): xs [T, ..., n_in], carry
    batched over the non-time axes -> (ys [T, ..., total_out],
    final_carry). A loop over apply_net; autograd unrolls it backwards."""
    ys = []
    for x in xs.unbind(0):
        y, carry = apply_net(params, spec, x, carry)
        ys.append(y)
    return torch.stack(ys), carry

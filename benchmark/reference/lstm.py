"""An LSTM stack and its truncated-BPTT window in plain PyTorch, written
from cselab/smarties' description (Network/Layers/Layer_LSTM.h; the
window of ReplayMemory/MemoryBuffer.cpp:393-402 and Network/Network.h:
155-193).

A layer of width h maps an input x [B, in] and its carry (h_prev,
c_prev) [B, h] to

    c~ = tanh(x Wc + h_prev Rc + bc)
    i  = sigm(x Wi + h_prev Ri + bi)
    f  = sigm(x Wf + h_prev Rf + bf)
    o  = sigm(x Wo + h_prev Ro + bo)
    c  = f c_prev + i c~,   h = o tanh(c),

weights [in, h] and [h, h], drawn U(-g, g) with Glorot's g = sqrt(6 /
(in + h)) for every gate; the biases are zero but the forget gate's,
which starts at 1. The stack's last h goes through a linear output
layer and the stdev head (benchmark/reference/nets.py's out.W, out.b,
param).

The window of a sampled step t is the positions t-W+1, ..., t, t+1 of
its episode, run from a zero carry. A position before the episode's
start is inactive: the carry passes it unchanged. The output at t is
the one a learner differentiates; the output at t+1 is the next
state's.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import nets

GATES = ("c", "i", "f", "o")


def leaf_shapes(arch: dict) -> list:
    """[(name, shape, init bound)] of the LSTM leaves, layer by layer:
    the input weights, the recurrent weights, the biases (bound 0: a
    constant). arch: n_in, hidden."""
    out = []
    sizes = [arch["n_in"]] + list(arch["hidden"])
    for i, (a, h) in enumerate(zip(sizes[:-1], sizes[1:])):
        g = math.sqrt(6.0 / (a + h))
        out += [(f"lstm{i}.W{k}", (a, h), g) for k in GATES]
        out += [(f"lstm{i}.R{k}", (h, h), g) for k in GATES]
        out += [(f"lstm{i}.b{k}", (h,), 0.0) for k in GATES]
    return out


def draw_weights(gen: torch.Generator, arch: dict, param_init=None,
                 device=None) -> dict:
    """The LSTM leaves from one uniform draw, then the output layer and
    the stdev head as nets.draw_weights draws them over the last hidden
    width, in f32: {name: tensor}."""
    shapes = leaf_shapes(arch)
    n = sum(math.prod(s) for _, s, g in shapes if g > 0)
    u = torch.rand((n,), generator=gen, device=device) * 2 - 1
    w, k = {}, 0
    for name, shape, g in shapes:
        if g > 0:
            m = math.prod(shape)
            w[name] = (u[k:k + m] * g).reshape(shape)
            k += m
        else:
            fill = 1.0 if name.endswith(".bf") else 0.0
            w[name] = torch.full(shape, fill, device=device)
    top = {**arch, "n_in": arch["hidden"][-1], "hidden": []}
    w.update(nets.draw_weights(gen, top, param_init, device))
    return w


def cell(w: dict, layer: int, x, h_prev, c_prev):
    """One LSTM layer's step -> (h, c)."""
    def pre(k):
        return (x @ w[f"lstm{layer}.W{k}"] + h_prev @ w[f"lstm{layer}.R{k}"]
                + w[f"lstm{layer}.b{k}"])
    c = (torch.sigmoid(pre("f")) * c_prev
         + torch.sigmoid(pre("i")) * torch.tanh(pre("c")))
    return torch.sigmoid(pre("o")) * torch.tanh(c), c


def head(w: dict, h):
    """The output layer and the stdev head on the top layer's h."""
    y = h @ w["out.W"] + w["out.b"]
    if "param" in w:
        y = torch.cat([y, w["param"].expand(y.shape[0], -1)], dim=-1)
    return y


def run(w: dict, arch: dict, xs, active, outputs):
    """The stack over positions p of xs [B, P, n_in] from a zero carry,
    holding the carry where active [B, P] is False -> the outputs at
    the positions in `outputs`, as {p: [B, n_out + n_param]}."""
    B = xs.shape[0]
    carry = [(xs.new_zeros((B, h)), xs.new_zeros((B, h)))
             for h in arch["hidden"]]
    out = {}
    for p in range(xs.shape[1]):
        x, new = xs[:, p], []
        for i, (h, c) in enumerate(carry):
            x, c1 = cell(w, i, x, h, c)
            new.append((x, c1))
        m = active[:, p, None]
        carry = [(torch.where(m, h1, h), torch.where(m, c1, c))
                 for (h1, c1), (h, c) in zip(new, carry)]
        if p in outputs:
            out[p] = head(w, x)
    return out


def window(w: dict, arch: dict, xs, active):
    """A BPTT window xs [B, W+1, n_in] (positions t-W+1 .. t+1) ->
    (output at t, output at t+1)."""
    P = xs.shape[1]
    out = run(w, arch, xs, active, (P - 2, P - 1))
    return out[P - 2], out[P - 1]

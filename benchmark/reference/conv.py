"""A conv stack, a dense layer and the output, in plain PyTorch, as
unfold (im2col) and matrix products: no cuDNN algorithm is shared with
a program that calls conv2d.

A conv layer (in_w, in_h, in_c, out_c, filter, stride), valid padding,
weights [out_c, in_c, filter, filter] (OIHW): y = W x_patch + b over
every filter-sized patch at the stride, then LRelu (0.01 x below 0).
The last conv's output is flattened in (row, column, channel) order,
then the dense layers act(x W + b) (weights [in, out]) and a linear
output layer. Conv weights are drawn U(-f, f) with He's f =
sqrt(2 / (filter^2 in_c)); the dense layers as benchmark/reference/
nets.py draws them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import nets


def conv_shapes(conv) -> list:
    """[(name, shape, init bound)] of the conv leaves."""
    out = []
    for i, (_, _, in_c, out_c, filt, _) in enumerate(conv):
        out += [(f"conv{i}.W", (out_c, in_c, filt, filt),
                 math.sqrt(2.0 / (filt * filt * in_c))),
                (f"conv{i}.b", (out_c,), 0.0)]
    return out


def draw_weights(gen: torch.Generator, arch: dict, param_init=None,
                 device=None) -> dict:
    """The dense leaves from one uniform draw, then the conv leaves from
    another, in f32: {name: tensor}."""
    w = nets.draw_weights(gen, arch, param_init, device)
    shapes = conv_shapes(arch["conv"])
    n = sum(math.prod(s) for _, s, f in shapes if f > 0)
    u = torch.rand((n,), generator=gen, device=device) * 2 - 1
    k = 0
    for name, shape, f in shapes:
        if f > 0:
            m = math.prod(shape)
            w[name] = (u[k:k + m] * f).reshape(shape)
            k += m
        else:
            w[name] = torch.zeros(shape, device=device)
    return w


def features(w: dict, conv, x):
    """x [B, in_c, in_h, in_w] -> the last conv's output [B, h * w * c]."""
    h = x
    for i, (_, _, _, out_c, filt, stride) in enumerate(conv):
        B, _, in_h, in_w = h.shape
        cols = F.unfold(h, filt, stride=stride)       # [B, C k k, L]
        y = w[f"conv{i}.W"].reshape(out_c, -1) @ cols + \
            w[f"conv{i}.b"][:, None]
        oh, ow = (in_h - filt) // stride + 1, (in_w - filt) // stride + 1
        y = y.reshape(B, out_c, oh, ow)
        h = torch.where(y > 0, y, 0.01 * y)
    return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)


def forward(w: dict, arch: dict, x):
    """Net outputs [B, n_out] for standardized frames x [B, in_c * in_h
    * in_w], channel-major."""
    in_w, in_h, in_c = arch["conv"][0][:3]
    h = features(w, arch["conv"], x.reshape(-1, in_c, in_h, in_w))
    return nets.forward(w, arch, h)

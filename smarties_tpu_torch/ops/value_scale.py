"""R2D2-style value <-> network-output rescaling.

Port of smarties_tpu/ops/value_scale.py (reference:
Learners/RACER_common.cpp:14-32 scaleV2Net, scaleNet2V, scaleVdiff). The
network learns a compressed value v = h(V); the learner converts back
with h^{-1} and chains gradients with (h^{-1})'. Elementwise torch.
"""
import torch


def scale_v2net(x):
    """V -> net target: sign(x)*(sqrt(1+|x|)-1) + 1e-2*x."""
    pos = 1e-2 * x + torch.sqrt(1 + x) - 1
    neg = 1e-2 * x - torch.sqrt(1 - x) + 1
    zero = torch.zeros_like(x)
    return torch.where(x > 0, pos, torch.where(x < 0, neg, zero))


def scale_net2v(x):
    """net output -> V (inverse of scale_v2net)."""
    pos = 100 * (x + 51) - 100 * torch.sqrt(2601 + 100 * x)
    neg = 100 * (x - 51) + 100 * torch.sqrt(2601 - 100 * x)
    zero = torch.zeros_like(x)
    return torch.where(x > 0, pos, torch.where(x < 0, neg, zero))


def scale_vdiff(x):
    """d scale_net2v / d x — chain-rule factor for value gradients."""
    pos = 100 - 5000 / torch.sqrt(2601 + 100 * x)
    neg = 100 - 5000 / torch.sqrt(2601 - 100 * x)
    return torch.where(x > 0, pos, neg)

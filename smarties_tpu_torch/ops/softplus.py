"""The reference's positive-definite mapping ("cheap SoftPlus").

Port of smarties_tpu/ops/softplus.py (reference: Network/Layers/
Functions.h:541-584): f(x) = (x + sqrt(1+x^2))/2,
f'(x) = (1 + x/sqrt(1+x^2))/2, f^{-1}(y) = (y^2 - 1/4)/y.
"""
import torch


def softplus(x):
    return (x + torch.sqrt(1 + x * x)) / 2


def softplus_diff(x):
    return (1 + x / torch.sqrt(1 + x * x)) / 2


def softplus_inv(y):
    """Inverse; requires y > 0. Works on python floats and tensors."""
    return (y * y - 0.25) / y

"""Adam with the reference's exact update rule.

Port of smarties_tpu/models/optim.py (reference: Network/Optimizer.
{h,cpp}) with the compile-time defaults ON (Settings/Bund.h:76-88):
SMARTIES_SAFE_ADAM (second moment floored at M1^2),
SMARTIES_NESTEROV_ADAM (lookahead numerator) and SMARTIES_ADAMW
(decoupled weight decay). The update is an ASCENT step,
param += eta * step: the learners produce ascent directions.
torch.optim.Adam implements none of these and is not used.

The port updates the parameter leaves and the moments IN PLACE (the JAX
package rebuilds them); the scalars beta_t_1, beta_t_2 and step are 0-d
device tensors, so a step never synchronises with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from smarties_tpu_torch.models.net import tree_leaves, tree_map
from smarties_tpu_torch.utils.config import anneal_rate

NN_EPS = float(np.finfo(np.float32).eps)  # nnEPS (Bund.h:118)


class AdamState(NamedTuple):
    m1: dict                 # first moment, the params' structure
    m2: dict                 # second moment
    beta_t_1: torch.Tensor   # 0-d f32
    beta_t_2: torch.Tensor   # 0-d f32
    step: torch.Tensor       # 0-d i32


class AdamConfig(NamedTuple):
    eta: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    lambda_: float = 0.0       # nnLambda, decoupled L2
    eps_anneal: float = 0.0    # epsAnneal for lr annealing
    anneal_lr: bool = True     # bAnnealLearnRate (Optimizer.h:45)


def adam_init(params) -> AdamState:
    dev = tree_leaves(params)[0].device
    zeros = lambda x: torch.zeros_like(x, requires_grad=False)
    return AdamState(
        m1=tree_map(zeros, params), m2=tree_map(zeros, params),
        beta_t_1=torch.tensor(0.9, dtype=torch.float32, device=dev),
        beta_t_2=torch.tensor(0.999, dtype=torch.float32, device=dev),
        step=torch.tensor(0, dtype=torch.int32, device=dev))


@torch.no_grad()
def adam_step(params, grads, state: AdamState, cfg: AdamConfig,
              grad_factor):
    """One Adam ascent step, in place. `grads` are summed ascent
    gradients with the params' structure; the reference divides by
    batchSize via `grad_factor` (Optimizer.cpp:130).

    Returns (params, new_state): the same parameter and moment tensors,
    updated, and new 0-d scalars."""
    b1, b2 = cfg.beta1, cfg.beta2
    eta = cfg.eta
    if cfg.anneal_lr:
        eta = anneal_rate(eta, state.step.to(torch.float32), cfg.eps_anneal)
    # bias-corrected step size (Adam ctor, Optimizer.cpp:62-67)
    eta_t = eta * torch.sqrt(1 - state.beta_t_2) / (1 - state.beta_t_1)
    for w, g, m1, m2 in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state.m1), tree_leaves(state.m2)):
        dw = grad_factor * g            # ADAMW: penalty not in the moments
        m1.copy_(b1 * m1 + (1 - b1) * dw)
        m2.copy_(torch.maximum(b2 * m2 + (1 - b2) * dw * dw,
                               m1 * m1))            # SAFE_ADAM
        numer = b1 * m1 + (1 - b1) * dw             # NESTEROV_ADAM
        ret = numer / (NN_EPS + torch.sqrt(m2))
        penal = -w * cfg.lambda_                    # AdamW decoupled decay
        w.add_(eta_t * (ret + penal))
    # beta_t *= beta, floored to 0 below nnEPS (Optimizer.cpp:156-160)
    bt1 = state.beta_t_1 * b1
    bt1 = torch.where(bt1 < NN_EPS, torch.zeros_like(bt1), bt1)
    bt2 = state.beta_t_2 * b2
    bt2 = torch.where(bt2 < NN_EPS, torch.zeros_like(bt2), bt2)
    return params, AdamState(state.m1, state.m2, bt1, bt2, state.step + 1)

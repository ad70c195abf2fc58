"""Adam with the reference's exact update rule.

Port of smarties_tpu/models/optim.py (reference: Network/Optimizer.
{h,cpp}) with the compile-time defaults ON (Settings/Bund.h:76-88):
SMARTIES_SAFE_ADAM (second moment floored at M1^2),
SMARTIES_NESTEROV_ADAM (lookahead numerator) and SMARTIES_ADAMW
(decoupled weight decay). The update is an ASCENT step,
param += eta * step: the learners produce ascent directions.
torch.optim.Adam implements none of these and is not used.

The port updates the parameter leaves, the moments and the 0-d device
scalars beta_t_1, beta_t_2 and step IN PLACE (the JAX package rebuilds
them): a step never synchronises with the host, and a CUDA graph of it
(runtime/graphs.py) reads and writes the same storage at every replay.

adam_update_ and adam_advance_ dispatch on the leaves' device: CPU
leaves take the plain loops (adam_update_plain_, adam_advance_plain_),
CUDA leaves one launch each of csrc/adam.cu (ops/adam_kernel.py), which
is bit-equal to the loops and raises on what it does not take.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from smarties_tpu_torch.models.net import tree_leaves, tree_map
from smarties_tpu_torch.ops import adam_kernel
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
def adam_update_(params, grads, state: AdamState, cfg: AdamConfig,
                 grad_factor):
    """adam_update_plain_ on CPU leaves; on CUDA leaves one launch of the
    Adam kernel (ops/adam_kernel.py), bit-equal to it."""
    ws = tree_leaves(params)
    if ws[0].device.type == "cpu":
        return adam_update_plain_(params, grads, state, cfg, grad_factor)
    adam_kernel.update_(ws, tree_leaves(grads), tree_leaves(state.m1),
                        tree_leaves(state.m2), state, cfg, grad_factor,
                        NN_EPS)


@torch.no_grad()
def adam_update_plain_(params, grads, state: AdamState, cfg: AdamConfig,
                       grad_factor):
    """The moments and parameters of one Adam ascent step, in place, with
    the bias correction of `state`'s scalars, which it leaves as they
    are (adam_advance_ moves them). `grads` are summed ascent gradients
    with the params' structure; the reference divides by batchSize via
    `grad_factor` (Optimizer.cpp:130)."""
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


@torch.no_grad()
def adam_advance_(state: AdamState, cfg: AdamConfig) -> AdamState:
    """adam_advance_plain_ on CPU scalars; on CUDA scalars one launch of
    the Adam kernel's advance (ops/adam_kernel.py)."""
    if state.step.device.type == "cpu":
        return adam_advance_plain_(state, cfg)
    adam_kernel.advance_(state, cfg, NN_EPS)
    return state


@torch.no_grad()
def adam_advance_plain_(state: AdamState, cfg: AdamConfig) -> AdamState:
    """The end of a step, in place: beta_t *= beta, floored to 0 below
    nnEPS (Optimizer.cpp:156-160), and step + 1."""
    for bt, b in ((state.beta_t_1, cfg.beta1), (state.beta_t_2, cfg.beta2)):
        bt.mul_(b).masked_fill_(bt < NN_EPS, 0.0)
    state.step.add_(1)
    return state


def adam_step(params, grads, state: AdamState, cfg: AdamConfig,
              grad_factor):
    """One Adam ascent step, in place: adam_update_, then adam_advance_.

    Returns (params, state): the same parameter, moment and scalar
    tensors, updated."""
    adam_update_(params, grads, state, cfg, grad_factor)
    return params, adam_advance_(state, cfg)


@torch.no_grad()
def update_target(params, target, target_delay: float, step):
    """Target-weight update (Optimizer.cpp:163-178), in place on `target`:
    targetDelay >= 1 copies the weights when step % int(targetDelay) == 0,
    decided on the device from the 0-d `step`; 0 < targetDelay < 1 is
    Polyak averaging with rate targetDelay; 0 leaves the targets alone.
    The learners pass the post-increment step, as the JAX package does."""
    if target_delay <= 0:
        return target
    pairs = zip(tree_leaves(target), tree_leaves(params))
    if target_delay >= 1:
        do_copy = (step % int(target_delay)) == 0
        for t, w in pairs:
            t.copy_(torch.where(do_copy, w, t))
    else:
        for t, w in pairs:
            t.lerp_(w, float(target_delay))
    return target

"""Advantage-function parameterizations for the RACER family and NAF.

Port of smarties_tpu/ops/advantages.py (reference: Math/{Zero_advantage,
Discrete_advantage,Gaus_advantage,Quadratic_advantage}.h). Batched over
leading axes. The policy-dependent factors are detached exactly where the
JAX package stop-gradients them: the reference never backpropagates an
advantage into the policy head.

Per-sample gradients. The JAX learners take d A_b / d(inputs_b) row by
row with jax.vmap(jax.grad(...)). Each sample's advantage depends only on
its own row, so the gradient of the batch SUM with respect to the batched
inputs has exactly those rows: `per_sample_grad` takes one
torch.autograd.grad of the sum, with respect to detached copies of the
inputs that require grad.
"""
from __future__ import annotations

import torch

from smarties_tpu_torch.ops.softplus import softplus


def per_sample_grad(adv_fn, inputs, wrt=(0,)):
    """Rows of d adv_fn(*inputs)[b] / d inputs[i][b] for each i in `wrt`,
    as a tuple of tensors shaped like those inputs. adv_fn maps batched
    inputs to a batched advantage [B] whose row b reads row b only."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(i in wrt)
              for i, x in enumerate(inputs)]
        out = adv_fn(*xs)
        return torch.autograd.grad(out.sum(), [xs[i] for i in wrt])


# ---------------------------------------------------------------------------
# Discrete advantage (RACER-discrete), Discrete_advantage.h:25-80
# ---------------------------------------------------------------------------

def discrete_n_outputs(n_opts: int) -> int:
    return n_opts


def discrete_advantage(adv_out, option, probs):
    """A(option) = adv[option] - sum_j pi_j adv_j, probs constant
    (the reference's grad is Qer (onehot - probs), :49-57)."""
    probs = probs.detach()
    a_sel = torch.gather(adv_out, -1, option.long()[..., None])[..., 0]
    return a_sel - torch.sum(probs * adv_out, dim=-1)


# ---------------------------------------------------------------------------
# Gaussian advantage (RACER-continuous), Gaus_advantage.h:17-128;
# nL = 1 + 2 nA outputs [coef, p_hi, p_lo]
# ---------------------------------------------------------------------------

def gaussian_n_outputs(n_act: int) -> int:
    return 1 + 2 * n_act


def gaussian_initial_bias(n_act: int):
    """setInitial pushes [-1, 1, 1, ...] (Gaus_advantage.h:33-36)."""
    return [-1.0] + [1.0] * (2 * n_act)


def gaussian_advantage(adv_out, action, pol_mean, pol_var,
                       stop_policy_grad: bool = True):
    """A(a) = coef (exp(-0.5 sum (a-m)^2 / p_side) - mixRatio).

    pol_mean is the policy's effective (clamped) mean. Both policy factors
    are constants by default; stop_policy_grad=False lets the gradient
    flow through the bump centre (never the mix-ratio variance): the
    Gaussian-NAF mode."""
    m = pol_mean.detach() if stop_policy_grad else pol_mean
    v = pol_var.detach()
    nA = m.shape[-1]
    coef = softplus(adv_out[..., 0])
    p_hi = softplus(adv_out[..., 1:1 + nA])
    p_lo = softplus(adv_out[..., 1 + nA:1 + 2 * nA])
    d = action - m
    p_side = torch.where(d > 0, p_hi, p_lo)
    shape = -0.5 * torch.sum(d * d / p_side, dim=-1)
    mix = (torch.sqrt(p_hi / (p_hi + v)) + torch.sqrt(p_lo / (p_lo + v))) / 2
    # the product over the action dims as a chain of multiplies: on a card
    # torch.prod's backward reads back whether an input is zero, which no
    # captured step may do (runtime/graphs.py)
    ratio = mix[..., 0]
    for i in range(1, nA):
        ratio = ratio * mix[..., i]
    return coef * (torch.exp(shape) - ratio)


# ---------------------------------------------------------------------------
# Quadratic advantage (NAF): -(a-m)^T L L^T (a-m) / 2, lower-triangular L
# with a SoftPlus diagonal (Quadratic_term.h, Quadratic_advantage.h)
# ---------------------------------------------------------------------------

def quadratic_n_outputs(n_act: int) -> int:
    """nA (nA+1) / 2 matrix entries; the mean is a separate slice."""
    return n_act * (n_act + 1) // 2


def _build_L(l_out, n_act: int):
    """Pack the tril entries in row-major tril order; diagonal through
    SoftPlus (Quadratic_term.h extract_L)."""
    # made on the device: host index arrays would be copied there at every
    # call, which no captured step may do
    rows, cols = torch.tril_indices(n_act, n_act, device=l_out.device)
    L = l_out.new_zeros(tuple(l_out.shape[:-1]) + (n_act, n_act))
    L[..., rows, cols] = l_out
    diag = softplus(torch.diagonal(L, dim1=-2, dim2=-1))
    eye = torch.eye(n_act, dtype=l_out.dtype, device=l_out.device)
    return torch.where(eye.bool(), diag[..., None, :] * eye, L)


def quadratic_advantage(l_out, mean_out, action, n_act: int,
                        pol_mean=None, pol_var=None):
    """A(a) = -0.5 (a-m)^T P (a-m) [+ centring when a policy is given],
    P = L L^T (Quadratic_advantage.h computeAdvantage). NAF uses the
    no-policy form (own mean)."""
    L = _build_L(l_out, n_act)
    P = L @ L.transpose(-1, -2)
    d = (action - mean_out)[..., None]
    ret = -(d.transpose(-1, -2) @ P @ d)[..., 0, 0]
    if pol_mean is not None:
        dp = (pol_mean.detach() - mean_out)[..., None]
        ret = ret + (dp.transpose(-1, -2) @ P @ dp)[..., 0, 0]
        ret = ret + torch.sum(torch.diagonal(P, dim1=-2, dim2=-1)
                              * pol_var.detach(), dim=-1)
    return 0.5 * ret

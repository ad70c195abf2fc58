"""Categorical policy over discrete options.

Port of smarties_tpu/ops/discrete_policy.py (reference:
Math/Discrete_policy.h). Probabilities are not a softmax but a
Func-normalization, p_i = f(o_i) / sum_j f(o_j), with f the cheap
SoftPlus (Discrete_policy) or exp (the Boltzmann policy of soft DQN,
DQN.cpp:15-37). Batched with the option axis last; options are integer
tensors of the leading shape.

The JAX package draws with jax.random.categorical, which torch cannot
reproduce. The port draws by inverse CDF from a uniform taken from a
torch.Generator: `sample_with_uniform(u, probs)` is the seam through
which a test pins the draw.
"""
from __future__ import annotations

import numpy as np
import torch

from smarties_tpu_torch.ops.softplus import softplus, softplus_diff

_EPS = float(np.finfo(np.float32).eps)


def _at(x, option):
    """x[..., option] for an integer option tensor of x's leading shape."""
    return torch.gather(x, -1, option.long()[..., None])[..., 0]


def probs_of(outputs, fn="softplus"):
    """Net outputs -> (unnorm, norm, probs) (extract_unnorm/compute_norm/
    extract_probabilities, Discrete_policy.h:56-77). For "exp" the row max
    is subtracted as a constant: exact for the probabilities."""
    if fn == "softplus":
        un = softplus(outputs)
    elif fn == "exp":
        un = torch.exp(outputs - torch.amax(outputs, dim=-1,
                                            keepdim=True).detach())
    else:
        raise ValueError(fn)
    norm = torch.clamp(torch.sum(un, dim=-1, keepdim=True), min=_EPS)
    return un, norm, un / norm


def imp_weight(option, probs, mu):
    """rho = pi(option) / mu(option) (importanceWeight, :83-89)."""
    return _at(probs, option) / _at(mu, option)


def logprob(option, probs):
    return torch.log(_at(probs, option))


def kl_mu_pi(mu, probs):
    """sum_i p_i log(p_i / mu_i), the reference's KLDivergence
    (Discrete_policy.h:120-124)."""
    return torch.sum(probs * torch.log(probs / torch.clamp(mu, min=_EPS)),
                     dim=-1)


def _fn_diff(outputs, unnorm, fn):
    if fn == "softplus":
        return softplus_diff(outputs)
    return unnorm            # d/do exp(o - c) with c constant


def pol_grad(option, outputs, unnorm, norm, probs, coef, fn="softplus"):
    """Analytic d(coef * log pi(option)) / d(net outputs) [..., nO]
    (policyGradient, Discrete_policy.h:126-137):
    g_i = f'(o_i) * coef * (1{i==option} / f(o_option) - 1/norm)."""
    onehot = torch.nn.functional.one_hot(option.long(), probs.shape[-1]
                                         ).to(probs.dtype)
    un_opt = torch.gather(unnorm, -1, option.long()[..., None])
    g = coef[..., None] * (onehot / un_opt - 1.0 / norm)
    return g * _fn_diff(outputs, unnorm, fn)


def kl_grad(mu, outputs, unnorm, norm, probs, coef, fn="softplus"):
    """Analytic d(coef * KL) / d(net outputs) (KLDivGradient,
    Discrete_policy.h:146-157): tmp_j = coef (1 + log(p_j/mu_j)) / norm,
    g_i = f'(o_i) (tmp_i - sum_j tmp_j p_j)."""
    tmp = coef[..., None] * (1 + torch.log(probs / torch.clamp(mu, min=_EPS))
                             ) / norm
    g = tmp - torch.sum(tmp * probs, dim=-1, keepdim=True)
    return g * _fn_diff(outputs, unnorm, fn)


def sample_with_uniform(u, probs):
    """Inverse-CDF draw: the option whose cumulative-probability interval
    holds u * sum(probs), for u in [0, 1) of the leading shape. An option
    of probability 0 has an empty interval and is never drawn."""
    c = torch.cumsum(probs, dim=-1)
    below = (c <= (u.to(c.dtype)[..., None] * c[..., -1:])).to(torch.long)
    return torch.clamp(torch.sum(below, dim=-1), max=probs.shape[-1] - 1)


def sample(gen: torch.Generator, probs):
    """Categorical draw over probs (Discrete_policy.h:169-177)."""
    u = torch.rand(tuple(probs.shape[:-1]), generator=gen,
                   dtype=probs.dtype, device=probs.device)
    return sample_with_uniform(u, probs)


def select(gen: torch.Generator, probs, train: bool, u=None):
    """Sample when training, argmax otherwise (selectAction, :188-191).
    u: the uniform to draw with instead of one from gen."""
    if not train:
        return torch.argmax(probs, dim=-1)
    if u is None:
        return sample(gen, probs)
    return sample_with_uniform(u, probs)

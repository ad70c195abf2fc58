"""Diagonal Gaussian policy, with optionally tanh-squashed (bounded) dims.

Port of smarties_tpu/ops/continuous_policy.py (reference:
Math/Continuous_policy.h — NormalPolicy :68-210 for unbounded dims,
SquashedNormalPolicy :212-390 for bounded dims, chosen per dim by a
static bounded mask). Batched over leading axes, action dims last.

The gradients of the training objective with respect to the network
OUTPUTS are analytic — gradLogP / gradKLdiv (Continuous_policy.h:146-175,
:303-338) with the squashed-policy anti-NaN gates — and are pulled back
through the network with autograd (algos/vracer.py), as the reference
sets the output-layer gradient and backpropagates.

Random draws come from an explicit torch.Generator: `sample` draws the
clipped normals and hands them to `sample_with_noise`, so a test can
inject the noise.
"""
from __future__ import annotations

import numpy as np
import torch

from smarties_tpu_torch.ops.softplus import (softplus, softplus_diff,
                                             softplus_inv)

# tanh(MEAN_MAX) == 1 - float32 eps (Continuous_policy.h:218-223)
MEAN_MAX = 8.31776613503286
# exploration noise is clipped to +-NORMDIST_MAX (Bund.h:100)
NORMDIST_MAX = 3.0
_LOG_SQRT_2PI = 0.9189385332046727
_F32_TINY = float(np.finfo(np.float32).tiny)
_LOGW_CLIP = 7.0
# DKL(pi || mu), the reference's compiled default (Bund.h:43)
OPPOSITE_KL = True


def _mask(bounded, like: torch.Tensor) -> torch.Tensor:
    """Per-dim bounded mask as a bool tensor on `like`'s device. Hot
    callers pass a bool tensor already there (no host-to-device copy);
    a host mask is copied, which is fine off the hot path."""
    if isinstance(bounded, torch.Tensor) and bounded.device == like.device:
        return bounded
    return torch.as_tensor(np.asarray(bounded, bool), device=like.device)


def sigma_of(sigma_raw):
    """Raw net output -> stdev via cheap SoftPlus (Continuous_policy.h:79)."""
    return softplus(sigma_raw)


def initial_sigma_raw(expl_noise):
    """Net bias producing stdev == explNoise (:179, :343); 0 is clamped to
    float eps (Continuous_policy.h:603-608)."""
    return softplus_inv(max(float(expl_noise),
                            float(np.finfo(np.float32).eps)))


def eff_mean(mean, bounded):
    """Mean used for logprob/sampling: clamped on squashed dims
    (SquashedNormalPolicy::getMean, Continuous_policy.h:218-223)."""
    return torch.where(_mask(bounded, mean),
                       torch.clamp(mean, -MEAN_MAX, MEAN_MAX), mean)


def _logprob_dims(act, m_eff, sigma, bounded):
    """Per-dim log pi(a); squashed dims add -log J (:241-249)."""
    inv_s = 1.0 / sigma
    arg = -torch.square((act - m_eff) * inv_s) / 2
    base = arg + torch.log(inv_s) - _LOG_SQRT_2PI
    squash = torch.tanh(act)
    jac = torch.clamp(1 - squash * squash, min=_F32_TINY)
    return torch.where(_mask(bounded, act), base - torch.log(jac), base)


def logprob(act, mean, sigma, bounded):
    """Total log pi(a) summed over dims (evalLogProbability, :675-680)."""
    m_eff = eff_mean(mean, bounded)
    return torch.sum(_logprob_dims(act, m_eff, sigma, bounded), dim=-1)


def logprob_mu(act, mu, bounded):
    """log mu(a) for a stored behavior vector mu = [means, stdevs]."""
    n = mu.shape[-1] // 2
    return torch.sum(_logprob_dims(act, mu[..., :n], mu[..., n:], bounded),
                     dim=-1)


def imp_weight(act, mean, sigma, mu, bounded):
    """rho = pi(a)/mu(a) with log-space clip to +-7 (:648-653)."""
    logw = logprob(act, mean, sigma, bounded) - logprob_mu(act, mu, bounded)
    return torch.exp(torch.clamp(logw, -_LOGW_CLIP, _LOGW_CLIP))


def kl_div(mu, mean, sigma, opposite=OPPOSITE_KL):
    """KL divergence between pi and the stored behavior mu: DKL(pi||mu)
    when opposite (the default, :135-138), else DKL(mu||pi) (:131-134).
    Uses the unclamped mean, as the reference does."""
    n = mu.shape[-1] // 2
    m_mu, s_mu = mu[..., :n], mu[..., n:]
    if opposite:
        c = torch.square(sigma / s_mu)
        dm = torch.square((mean - m_mu) / s_mu)
    else:
        inv_s = 1.0 / sigma
        c = torch.square(s_mu * inv_s)
        dm = torch.square((mean - m_mu) * inv_s)
    return torch.sum((c - 1 + dm - torch.log(c)) / 2, dim=-1)


def pol_grad(act, mean, sigma, sigma_raw, coef, bounded):
    """Analytic d(coef * log pi(a)) / d(net outputs) ->
    (d_mean_out, d_sigma_raw_out), each [..., nA] (NormalPolicy::gradLogP
    :146-154, SquashedNormalPolicy::gradLogP :303-322 with the anti-NaN
    gate on saturated means)."""
    coef = coef[..., None]
    inv_s = 1.0 / sigma
    m_eff = eff_mean(mean, bounded)
    d_mean = coef * (act - mean) * inv_s * inv_s
    u = (act - m_eff) * inv_s
    d_sig = softplus_diff(sigma_raw) * coef * (u * u - 1) * inv_s
    sat = ((mean >= MEAN_MAX) & (d_mean > 0)) \
        | ((mean <= -MEAN_MAX) & (d_mean < 0))
    gated = torch.where(sat, torch.zeros_like(d_mean), d_mean)
    d_mean = torch.where(_mask(bounded, mean), gated, d_mean)
    return d_mean, d_sig


def kl_grad(mu, mean, sigma, sigma_raw, coef, opposite=OPPOSITE_KL):
    """Analytic d(coef * KL) / d(net outputs) (gradKLdiv, :156-170,
    :324-338)."""
    n = mu.shape[-1] // 2
    m_mu, s_mu = mu[..., :n], mu[..., n:]
    coef = coef[..., None]
    dm = mean - m_mu
    if opposite:
        inv_var_mu = 1.0 / (s_mu * s_mu)
        d_mean = coef * dm * inv_var_mu
        d_sig = (softplus_diff(sigma_raw) * coef
                 * (inv_var_mu - 1.0 / (sigma * sigma)) * sigma)
    else:
        inv_s = 1.0 / sigma
        var, var_mu = sigma * sigma, s_mu * s_mu
        d_mean = coef * dm * inv_s * inv_s
        d_sig = (softplus_diff(sigma_raw) * coef
                 * (var - var_mu - dm * dm) * inv_s * inv_s * inv_s)
    return d_mean, d_sig


def clipped_normal(gen: torch.Generator, shape, like: torch.Tensor):
    """N(0,1) noise; draws beyond +-NORMDIST_MAX are replaced by a uniform
    draw in [-NORMDIST_MAX, NORMDIST_MAX] (sampleClippedGaussian,
    Continuous_policy.h:184-191)."""
    kw = dict(dtype=like.dtype, device=like.device)
    z = torch.randn(shape, generator=gen, **kw)
    u = torch.empty(shape, **kw).uniform_(-NORMDIST_MAX, NORMDIST_MAX,
                                          generator=gen)
    return torch.where(torch.abs(z) > NORMDIST_MAX, u, z)


def sample(gen: torch.Generator, mean, sigma, bounded,
           share_agents: int = 1):
    """Draw a learner-space action (SquashedNormalPolicy::sample,
    :355-359). share_agents > 1: groups of that many leading rows share
    one noise draw (Agent::sampleActionNoise, Agent.h:315-342)."""
    if share_agents > 1:
        g = mean.shape[0] // share_agents
        z = clipped_normal(gen, (g, 1) + tuple(mean.shape[1:]), mean)
        z = z.expand((g, share_agents) + tuple(mean.shape[1:])
                     ).reshape(mean.shape)
    else:
        z = clipped_normal(gen, tuple(mean.shape), mean)
    return sample_with_noise(z, mean, sigma, bounded)


def sample_with_noise(noise, mean, sigma, bounded):
    """sample() given the noise draw."""
    a = eff_mean(mean, bounded) + sigma * noise
    return torch.where(_mask(bounded, a),
                       torch.clamp(a, -MEAN_MAX, MEAN_MAX), a)


def mu_vector(mean, sigma, bounded):
    """Behavior-policy vector stored into replay: [means, stdevs] with
    squashed means clamped (getVector, Continuous_policy.h:745-752)."""
    return torch.cat([eff_mean(mean, bounded), sigma], dim=-1)

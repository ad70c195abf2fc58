"""Synthetic inputs of V-RACER's continuous head (algos/vracer.py::
VRacer.output_grad), for tests/test_torch_policy_head.py on the CPU and
tests/test_torch_policy_head_cuda.py on the card: a learner over an MDP of
nA action dims with a bounded, an unbounded or a mixed mask, the net's
outputs at B sampled rows, the minibatch's actions, behaviour vectors,
returns and valid flags, and the replay's 0-d cmax_ret, cinv_ret and
beta. The values come from a CPU generator and move to the device, so
both files see the same numbers. This module imports neither jax nor the
JAX package.

Each case reaches the branches of the head: means beyond +-MEAN_MAX on
both sides of gradLogP's saturation gate, actions past tanh's saturation
(the Jacobian's clamp), log-weights past the +-7 clip, rho about the
far-policy bounds 1/C and C, V-outputs of both signs, 0 and tiny ones,
and invalid rows."""
from types import SimpleNamespace

import numpy as np
import torch

from smarties_tpu_torch.algos.vracer import Racer, VRacer
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.utils.config import HyperParameters

MEAN_MAX = float(np.float32(cp.MEAN_MAX))


def mask(kind: str, nA: int):
    """The bounded mask of a case: every dim, none, or every other."""
    return tuple({"bounded": True, "unbounded": False}.get(kind, d % 2 == 0)
                 for d in range(nA))


def learner(nA=1, kind="bounded", family="vracer"):
    """V-RACER (the zero advantage), RACER's Gaussian advantage or
    RACER-discrete over a 3-dim state."""
    cfg = HyperParameters(nnLayerSizes=[8], batchSize=32)
    if family == "discrete":
        return VRacer(MDPSpec(dim_state=3, dim_action=1,
                              discrete_values=(nA + 2,)), cfg)
    mdp = MDPSpec(dim_state=3, dim_action=nA, bounded=mask(kind, nA))
    return (Racer if family == "gaussian" else VRacer)(mdp, cfg)


def case(device, algo, B=256, seed=0, beta=0.37, cmax=4.0):
    """-> (out, mb, rs) for `algo`'s head: out [B, n_out], mb with action,
    mu, qret and valid, rs with cmax_ret, cinv_ret and beta (0-d)."""
    g = torch.Generator().manual_seed(seed)
    n_out = algo.spec.n_out + algo.spec.n_param_out

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    out = randn(B, n_out)
    # V-outputs of both signs, 0 and tiny
    out[:, 0] *= 3.0
    out[:8, 0] = torch.tensor([0.0, -0.0, 1e-30, -1e-30, 1e-7, -1e-7, 40.0,
                               -40.0])
    if algo.discrete:
        n = algo.n_opts
        action = torch.randint(0, n, (B, 1), generator=g).float()
        mu = torch.softmax(randn(B, n, scale=2.0), dim=-1)
    else:
        nA = algo.mdp.dim_action
        p0 = algo.pol_start
        means = out[:, p0:p0 + nA]
        means.mul_(3.0)
        # means at and past +-MEAN_MAX: the clamp and gradLogP's gate, on
        # both sides of it (the sign of the coefficient and of a - mean)
        r = torch.arange(8, 40)
        means[r] = (MEAN_MAX + torch.rand(32, nA, generator=g)
                    * torch.tensor([0.0, 2.0]).repeat(16)[:, None]) \
            * torch.tensor([1.0, -1.0]).repeat_interleave(16)[:, None]
        action = means.clone().clamp(-MEAN_MAX, MEAN_MAX) + randn(B, nA)
        # actions past tanh's saturation: the Jacobian's clamp
        action[40:48] = 9.5 * torch.tensor([1.0, -1.0]).repeat(4)[:, None]
        m_mu = action + randn(B, nA, scale=0.7)
        s_mu = torch.exp(randn(B, nA, scale=0.5))
        # log-weights past +-7: a narrow behaviour far from the action, a
        # narrow policy far from it
        s_mu[48:56] = 0.02
        out[56:64, p0 + nA:p0 + 2 * nA] = -30.0
        means[56:64] = action[56:64] + 3.0
        mu = torch.cat([m_mu, s_mu], dim=-1)
    qret = randn(B, scale=5.0)
    valid = torch.rand(B, generator=g) > 0.1
    dev = torch.device(device)
    c = torch.tensor(cmax, dtype=torch.float32)
    rs = SimpleNamespace(cmax_ret=c.to(dev), cinv_ret=(1.0 / c).to(dev),
                         beta=torch.tensor(beta, dtype=torch.float32,
                                           device=dev))
    mb = SimpleNamespace(action=action.to(dev), mu=mu.to(dev),
                         qret=qret.to(dev), valid=valid.to(dev))
    return out.to(dev), mb, rs


ROWS = ("g", "rho", "dkl", "delta_q", "v_val", "a_val", "is_far")


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 ulps between a and b (both finite;
    -0 and +0 are 0 apart)."""
    def key(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7fffffff), i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0

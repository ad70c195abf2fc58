"""V-RACER's continuous head on the CPU: the dispatcher
(algos/vracer.py::VRacer.output_grad), the chain it keeps
(output_grad_plain) and the wrapper of its CUDA kernel
(ops/policy_head_kernel.py) before any build or launch.

On the card tests/test_torch_policy_head_cuda.py holds the kernel itself
against the chain. Here:

- CPU tensors of V-RACER, RACER's Gaussian advantage and RACER-discrete
  take the chain: no launch is counted and the library is not loaded;
- the chain gives what the block of train_step that it replaced gave
  (that block, as it was, is `_block` below), on the synthetic cases and
  on a minibatch of a V-RACER trainer's replay;
- the wrapper takes the tensors a feed-forward and a recurrent V-RACER
  step hand it, and raises on float64, non-contiguous, two-device and
  misshapen inputs, more action dims than the kernel holds, and CPU
  tensors, without a launch;
- its float32 constants are those PyTorch rounds the chain's Python
  scalars to in the chain's float32 ops.

This file imports neither jax nor the JAX package.
"""
import numpy as np
import pytest
import torch

import _torch_head_cases as cases
from smarties_tpu_torch.algos import base
from smarties_tpu_torch.envs import cartpole
from smarties_tpu_torch.ops import advantages as adv_ops
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import discrete_policy as dpol
from smarties_tpu_torch.ops import policy_head_kernel as phk
from smarties_tpu_torch.ops.value_scale import scale_net2v, scale_vdiff
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters

torch.set_num_threads(1)


@torch.no_grad()
def _block(self, out, mb, rs):
    """The head as train_step computed it inline before output_grad_plain
    took it over, word for word, returning its rows."""
    a_t, mu_t, qret_t = mb.action, mb.mu, mb.qret
    v_raw, adv_out, pol, sraw = self._split_out(out)
    v_val = scale_net2v(v_raw)
    if self.discrete:
        opt = a_t[..., 0].long()
        un, norm, probs = dpol.probs_of(pol)
        rho = dpol.imp_weight(opt, probs, mu_t)
        dkl = dpol.kl_mu_pi(mu_t, probs)
        a_val = self._advantage(adv_out, opt, pol, probs=probs)
    else:
        bounded = self.mdp.consts(pol)[1]
        sigma = cp.sigma_of(sraw)
        rho = cp.imp_weight(a_t, pol, sigma, mu_t, bounded)
        dkl = cp.kl_div(mu_t, pol, sigma)
        a_val = self._advantage(adv_out, a_t, pol, sigma)

    cmax, cinv, beta = rs.cmax_ret, rs.cinv_ret, rs.beta
    is_far = rb.is_far_policy(rho, cmax, cinv)
    a_ret = qret_t - v_val                  # Retrace advantage
    delta_q = a_ret - a_val                 # TD error
    ver = torch.minimum(torch.ones_like(rho), rho) * delta_q

    # ---- analytic output gradient (ascent), :46-57 ----
    zero = torch.zeros_like(v_val)
    far2 = is_far[:, None]
    g_v = torch.where(is_far, zero, ver * beta * scale_vdiff(v_raw))
    pg_coef = torch.where(is_far, zero,
                          a_ret * torch.minimum(cmax, rho))
    if self.discrete:
        pol_g = dpol.pol_grad(opt, pol, un, norm, probs, pg_coef)
        pol_g = torch.where(far2, torch.zeros_like(pol_g), pol_g)
        pen_g = dpol.kl_grad(mu_t, pol, un, norm, probs,
                             -torch.ones_like(pg_coef))
        g_pol = beta * pol_g + (1 - beta) * pen_g
    else:
        pg_m, pg_s = cp.pol_grad(a_t, pol, sigma, sraw, pg_coef,
                                 bounded)
        pg_m = torch.where(far2, torch.zeros_like(pg_m), pg_m)
        pg_s = torch.where(far2, torch.zeros_like(pg_s), pg_s)
        pn_m, pn_s = cp.kl_grad(mu_t, pol, sigma, sraw,
                                -torch.ones_like(pg_coef))
        g_pol = torch.cat([beta * pg_m + (1 - beta) * pn_m,
                           beta * pg_s + (1 - beta) * pn_s], dim=-1)
    parts = [g_v[:, None]]
    if self.nL > 0:
        # advantage head: ADV.grad(a, isFar ? 0 : beta * Aer),
        # per-sample rows of dA/d(adv outputs)
        aer = torch.minimum(cmax, rho) * delta_q
        adv_coef = torch.where(is_far, zero, beta * aer)
        if self.discrete:
            g_adv, = adv_ops.per_sample_grad(
                adv_ops.discrete_advantage, (adv_out, opt, probs))
        else:
            g_adv, = adv_ops.per_sample_grad(
                adv_ops.gaussian_advantage,
                (adv_out, a_t, cp.eff_mean(pol, bounded),
                 sigma * sigma))
        parts.append(adv_coef[:, None] * g_adv)
    g = torch.cat(parts + [g_pol], dim=-1)
    # invalid (empty-replay) samples contribute no gradient
    g = torch.where(mb.valid[:, None], g, torch.zeros_like(g))
    return g, rho, dkl, delta_q, v_val, a_val, is_far


def _assert_equal(got, want):
    assert len(got) == len(want) == len(cases.ROWS)
    for name, x, y in zip(cases.ROWS, got, want):
        assert x.dtype == y.dtype and torch.equal(x, y), name


HEADS = [("vracer", 1, "bounded"), ("vracer", 2, "unbounded"),
         ("vracer", 6, "mixed"), ("gaussian", 1, "bounded"),
         ("gaussian", 3, "mixed"), ("discrete", 2, "bounded")]


@pytest.mark.parametrize("family, nA, kind", HEADS)
@pytest.mark.parametrize("beta, cmax", [(0.37, 4.0), (0.0, 1.0), (1.0, 4.0)],
                         ids=["beta_mid", "beta_0_no_filter", "beta_1"])
def test_cpu_takes_the_chain(family, nA, kind, beta, cmax):
    """CPU tensors take the chain, for every head: the rows are the
    replaced block's, no launch is counted and nothing is built or
    loaded. The counter is one that a graph replay advances."""
    algo = cases.learner(nA, kind, family)
    out, mb, rs = cases.case("cpu", algo, seed=nA, beta=beta, cmax=cmax)
    cuda_lib.reset_launches()
    got = algo.output_grad(out, mb, rs)
    _assert_equal(got, _block(algo, out, mb, rs))
    _assert_equal(algo.output_grad_plain(out, mb, rs), got)
    assert phk.launches == {"continuous": 0}
    assert not phk.LIB.loaded
    assert any(phk.launches is c for c in cuda_lib.COUNTERS)


@pytest.mark.parametrize("family", ["gaussian", "discrete"])
def test_other_heads_never_reach_the_kernel(family, monkeypatch):
    """RACER's Gaussian advantage and RACER-discrete keep the chain on
    any device: the dispatcher routes them there before it looks at the
    device (here a CUDA tensor is stood in for by a flag)."""
    algo = cases.learner(2, "mixed", family)
    out, mb, rs = cases.case("cpu", algo, seed=7)

    def refuse(*a, **k):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(phk, "continuous_head", refuse)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    _assert_equal(algo.output_grad(out, mb, rs), _block(algo, out, mb, rs))


def test_vracer_on_a_card_reaches_the_kernel(monkeypatch):
    """V-RACER's continuous head with CUDA tensors goes to the kernel's
    wrapper, with the minibatch's rows, the MDP's bounded mask and the
    replay's 0-d scalars (a CUDA tensor stood in for by a flag)."""
    algo = cases.learner(2, "mixed")
    out, mb, rs = cases.case("cpu", algo, seed=8)
    seen = []
    monkeypatch.setattr(phk, "continuous_head",
                        lambda *a: seen.append(a) or "kernel")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    assert algo.output_grad(out, mb, rs) == "kernel"
    (args,) = seen
    want = (out, mb.action, mb.mu, mb.qret, mb.valid,
            algo.mdp.consts(out)[1], rs.cmax_ret, rs.cinv_ret, rs.beta)
    assert len(args) == len(want)
    assert all(a is b for a, b in zip(args, want))
    assert phk.check_inputs(*args) == (256, 2)


def _trainer(**kw):
    cfg = HyperParameters(**dict(dict(
        minTotObsNum=128, maxTotObsNum=1024, batchSize=16,
        nnLayerSizes=[16], randSeed=0), **kw))
    tr = Trainer(cartpole, cartpole.MDP, cfg, n_envs=8, n_slots=32,
                 max_len=32, device="cpu")
    tr.warmup(chunk=4)
    return tr


@pytest.mark.parametrize("net", ["ff", "rnn"])
def test_trainer_minibatch(net):
    """A minibatch of a V-RACER trainer's replay and the net's outputs at
    its rows, as train_step hands them to the head (feed-forward: the
    first B rows of the forward over [s_t; s_t1]; recurrent: the output
    at the sampled step of a BPTT window): the wrapper takes them, and
    the chain gives the replaced block's rows."""
    kw = dict(nnType="GRU", nnBPTTseq=4) if net == "rnn" else {}
    tr = _trainer(**kw)
    algo, params, rs = tr.algo, tr.params, tr.replay
    gen = torch.Generator().manual_seed(3)
    mb = algo.sample_minibatch(rs, gen, None)
    with torch.no_grad():
        if algo.spec.is_recurrent:
            xs, active = base.bptt_window(rs, mb.ep, mb.t, 4)
            out, _, _ = base.seq_forward_vjp(params, algo.spec, xs, active)
        else:
            from smarties_tpu_torch.models.net import apply_net
            B = mb.s_t.shape[0]
            out_cat, _ = apply_net(params, algo.spec,
                                   torch.cat([mb.s_t, mb.s_t1]))
            out = out_cat[:B].detach()
    assert phk.check_inputs(out, mb.action, mb.mu, mb.qret, mb.valid,
                            algo.mdp.consts(out)[1], rs.cmax_ret,
                            rs.cinv_ret, rs.beta) == (16, 1)
    _assert_equal(algo.output_grad(out, mb, rs), _block(algo, out, mb, rs))


def _bad(name, out, mb, rs, bounded):
    """Replace one input by what the kernel does not take."""
    if name == "f64_out":
        out = out.double()
    elif name == "non_contiguous_out":
        out = out.t().contiguous().t()
    elif name == "non_contiguous_mu":
        mb.mu = torch.cat([mb.mu, mb.mu], dim=-1)[:, ::2]
    elif name == "two_devices":
        mb.qret = torch.zeros_like(mb.qret, device="meta")
    elif name == "f32_valid":
        mb.valid = mb.valid.float()
    elif name == "short_action":
        mb.action = mb.action[:-1]
    elif name == "wide_mu":
        mb.mu = torch.cat([mb.mu, mb.mu[:, :1]], dim=-1).contiguous()
    elif name == "even_width_out":
        out = out[:, :-1].contiguous()
    elif name == "f64_beta":
        rs.beta = rs.beta.double()
    elif name == "batched_cmax":
        rs.cmax_ret = rs.cmax_ret.expand(2).contiguous()
    elif name == "f32_bounded":
        bounded = bounded.float()
    elif name == "too_many_dims":
        nA = phk.MAX_DIMS + 1
        out = torch.zeros(out.shape[0], 1 + 2 * nA)
        mb.action = torch.zeros(out.shape[0], nA)
        mb.mu = torch.ones(out.shape[0], 2 * nA)
        bounded = torch.zeros(nA, dtype=torch.bool)
    return out, mb, rs, bounded


@pytest.mark.parametrize("bad", [
    "f64_out", "non_contiguous_out", "non_contiguous_mu", "two_devices",
    "f32_valid", "short_action", "wide_mu", "even_width_out", "f64_beta",
    "batched_cmax", "f32_bounded", "too_many_dims", "cpu"])
def test_wrapper_refuses(bad):
    """The wrapper raises on what the kernel does not take, and on CPU
    tensors, before any build or launch: there is no fallback."""
    algo = cases.learner(2, "mixed")
    out, mb, rs = cases.case("cpu", algo, seed=9)
    out, mb, rs, bounded = _bad(bad, out, mb, rs, algo.mdp.consts(out)[1])
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="policy_head_kernel"):
        phk.continuous_head(out, mb.action, mb.mu, mb.qret, mb.valid,
                            bounded, rs.cmax_ret, rs.cinv_ret, rs.beta)
    assert phk.launches == {"continuous": 0}
    assert not phk.LIB.loaded


def test_scalar_args_round_as_pytorch():
    """The kernel's constants are the float32 values that the chain's
    float32 ops use for its Python scalars: the clamp to +-MEAN_MAX and
    the saturation test against it, the subtraction of log sqrt(2 pi),
    the Jacobian's floor and the log-weight clip."""
    mean_max, log_sqrt_2pi, tiny, clip = phk.scalar_args()
    assert all(type(a) is np.float32 for a in phk.scalar_args())
    f32 = torch.float32
    up = float(np.nextafter(mean_max, np.float32(np.inf)))
    down = float(np.nextafter(mean_max, np.float32(0)))
    x = torch.tensor([float(mean_max), up, down, 100.0, -100.0], dtype=f32)
    assert torch.equal(torch.clamp(x, -cp.MEAN_MAX, cp.MEAN_MAX),
                       torch.clamp(x, -mean_max, mean_max))
    assert torch.clamp(x, -cp.MEAN_MAX, cp.MEAN_MAX)[3] == mean_max
    assert (x >= cp.MEAN_MAX).tolist() == [True, True, False, True, False]
    assert (-x <= -cp.MEAN_MAX).tolist() == [True, True, False, True, False]
    y = torch.tensor([0.0, 1.0, -3.5, 1e-8], dtype=f32)
    assert torch.equal(y - cp._LOG_SQRT_2PI,
                       y - torch.tensor(log_sqrt_2pi, dtype=f32))
    z = torch.tensor([0.0, 1e-39, 1e-37, -1.0], dtype=f32)
    assert torch.clamp(z, min=cp._F32_TINY).tolist() == [
        float(tiny), float(tiny), float(np.float32(1e-37)), float(tiny)]
    w = torch.tensor([7.5, -7.5, 6.0], dtype=f32)
    assert torch.clamp(w, -cp._LOGW_CLIP, cp._LOGW_CLIP).tolist() == [
        float(clip), -float(clip), 6.0]

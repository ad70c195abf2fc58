"""NAF: normalized advantage functions with a quadratic advantage.

Port of smarties_tpu/algos/naf.py (reference: Learners/NAF.{h,cpp},
Param_advantage == Quadratic_advantage): one network outputs
[V, lower-triangular L params, mean] plus a trainable stdev head used only
for exploration; Q(s, a) = V - 0.5 (a - m)^T L L^T (a - m). Targets are
Retrace or 1-step with the target net. The stdev is pulled toward
explNoise (fixExplorationGrad, NAF.cpp:160-161), and ReF-ER mixes the KL
penalty into the mean gradient only (NAF.cpp:156-159). `nafAdvGaussian`
swaps in the asymmetric-Gaussian advantage centred on the policy mean
(the JAX package's completion of the reference's NAF_ADV_GAUS switch).

The quirks of the JAX package are kept: the RAW value output (no R2D2
rescale), and the quadratic centre of bounded dims mapped through
HardSigmoid into [0, 1] while actions stay in the unbounded learner space
(Quadratic_term::extract_mean), which caps cart-pole returns.

Acting with clipImpWeight <= 0 uses Ornstein-Uhlenbeck noise; its state is
slot 0 of the per-env carry, which the collector zeroes at episode ends.
A recurrent nnType carries the recurrence in the single net: its carry
follows the OU state, and the online and target nets both run the
truncated-BPTT window (algos/base.py).
"""
from __future__ import annotations

import torch

from smarties_tpu_torch.algos.base import (Learner, backprop, bptt_window,
                                           check_ported, default_metrics,
                                           explore, grad_stats, ou_acting,
                                           post_step_processing,
                                           returns_mode_of, seq_forward_vjp,
                                           seq_outputs, target_copy,
                                           write_back_with_next)
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (Conv2DDesc, NetSpec, apply_net,
                                           init_carry, init_params)
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_init, adam_step,
                                             update_target)
from smarties_tpu_torch.ops import advantages as adv_ops
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops.softplus import softplus_diff
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters


def _hard_sigmoid(x):
    """Quadratic_term::BoundedActFunction (Functions.h:255-283)."""
    return 0.5 * (1 + x / torch.sqrt(1 + x * x))


class NAF(Learner):

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        if mdp.is_discrete:
            raise ValueError("NAF requires continuous actions")
        check_ported(mdp, cfg)
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        self.gaussian = bool(cfg.nafAdvGaussian)
        self.nL = (adv_ops.gaussian_n_outputs(nA) if self.gaussian
                   else adv_ops.quadratic_n_outputs(nA))
        # outputs: [V(1), L(nL), mean(nA)] + param stdev(nA) (NAF.cpp:39-44)
        self.l_start, self.m_start = 1, 1 + self.nL
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        # Gaus_advantage.h:30-36 biases the coef head to -1, widths to +1
        ob = (tuple([0.0] + adv_ops.gaussian_initial_bias(nA) + [0.0] * nA)
              if self.gaussian else ())
        self.spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
            conv=tuple(Conv2DDesc(*c) for c in mdp.conv_layers),
            n_out=1 + self.nL + nA, kind=cfg.nnType, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac, out_bias_init=ob,
            n_param_out=nA, param_init=tuple([sig0] * nA))
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        self.returns_mode = returns_mode_of(cfg, "none")

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        net = init_params(gen, self.spec, device)
        return {"net": net, "tgt": target_copy(net)}, adam_init(net)

    def init_rnn(self, n_envs: int, device=None):
        """Per-env carry: (Ornstein-Uhlenbeck noise state [n_envs, nA],
        *the net's recurrent carry)."""
        ou = torch.zeros((n_envs, self.mdp.dim_action), dtype=torch.float32,
                         device=device)
        return (ou,) + init_carry(self.spec, (n_envs,), device)

    def _split(self, out):
        nA = self.mdp.dim_action
        v = out[..., 0]
        l_out = out[..., self.l_start:self.l_start + self.nL]
        mean = out[..., self.m_start:self.m_start + nA]
        sraw = out[..., self.m_start + nA:self.m_start + 2 * nA]
        return v, l_out, mean, sraw

    def _advantage(self, l_out, mean_raw, action, sigma):
        """Quadratic: centre through HardSigmoid on bounded dims
        (Quadratic_term.h:75-86). Gaussian: the bump centred on the
        effective policy mean, trained through its centre
        (stop_policy_grad=False); sigma enters as a constant."""
        bounded = self.mdp.consts(mean_raw)[1]
        if self.gaussian:
            return adv_ops.gaussian_advantage(
                l_out, action, cp.eff_mean(mean_raw, bounded),
                sigma * sigma, stop_policy_grad=False)
        centre = torch.where(bounded, _hard_sigmoid(mean_raw), mean_raw)
        return adv_ops.quadratic_advantage(l_out, centre, action,
                                           self.mdp.dim_action)

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """act(params, obs_std, gen, rnn=(ou, *net carry), noise=None);
        `noise` is the clipped-normal draw [V, nA] that replaces one from
        `gen`."""
        spec, mdp = self.spec, self.mdp
        sample, use_ou = ou_acting(self.cfg, train)

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=(), noise=None):
            out, carry = apply_net(params["net"], spec, obs_std, rnn[1:])
            v, l_out, mean, sraw = self._split(out)
            ou = rnn[0] if rnn else torch.zeros_like(mean)
            sigma = cp.sigma_of(sraw)
            bounded = mdp.consts(mean)[1]
            if sample:
                a, ou = explore(gen, mean, sigma, bounded, ou, use_ou, noise)
            else:
                a = cp.eff_mean(mean, bounded)
            mu = cp.mu_vector(mean, sigma, bounded)
            return a, mu, v, self._advantage(l_out, mean, a, sigma), \
                (ou,) + carry

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None):
        """NAF::Train (NAF.cpp:121-165). In place; every value written back
        comes from the pre-step weights."""
        cfg, spec = self.cfg, self.spec
        mb = self.sample_minibatch(rs, gen, sample_override)
        net, tgt = params["net"], params["tgt"]
        if spec.is_recurrent:
            xs, active = bptt_window(rs, mb.ep, mb.t, cfg.nnBPTTseq)
            out, out_next, pullback = seq_forward_vjp(net, spec, xs, active)
        else:
            out_g, _ = apply_net(net, spec, mb.s_t)
            out = out_g.detach()

            def pullback(g):
                return backprop(net, out_g, g)

        with torch.no_grad():
            v, l_out, mean, sraw = self._split(out)
            bounded = self.mdp.consts(mean)[1]
            sigma = cp.sigma_of(sraw)
            rho = cp.imp_weight(mb.action, mean, sigma, mb.mu, bounded)
            dkl = cp.kl_div(mb.mu, mean, sigma)
            a_val = self._advantage(l_out, mean, mb.action, sigma)
            q_val = v + a_val
            is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
            if self.returns_mode != "none":
                target = mb.qret
                v_next = (out_next if spec.is_recurrent
                          else apply_net(net, spec, mb.s_t1)[0])[..., 0]
            else:
                v_next = (seq_outputs(tgt, spec, xs, active)[1]
                          if spec.is_recurrent
                          else apply_net(tgt, spec, mb.s_t1)[0])[..., 0]
                target = mb.reward_next + torch.where(
                    mb.terminal_next | is_far, torch.zeros_like(v_next),
                    cfg.gamma * v_next)
            error = torch.where(is_far, torch.zeros_like(q_val),
                                target - q_val)

            # output gradient: value + advantage rows (autograd) + ReF-ER
            # mean mix + stdev pulled to explNoise (NAF.cpp:148-161)
            g_l, g_m = adv_ops.per_sample_grad(
                lambda lo, m, s, a: self._advantage(lo, m, a, s),
                (l_out, mean, sigma, mb.action), wrt=(0, 1))
            g_l = error[:, None] * g_l
            g_m = error[:, None] * g_m
            if cfg.clipImpWeight > 0:
                pn_m, _ = cp.kl_grad(mb.mu, mean, sigma, sraw,
                                     -torch.ones_like(rho))
                g_m = rs.beta * g_m + (1 - rs.beta) * pn_m
            # fixExplorationGrad (Continuous_policy.h:172-177)
            g_s = softplus_diff(sraw) * (cfg.explNoise - sigma) / 2
            g = torch.cat([error[:, None], g_l, g_m, g_s], dim=-1)

        grads = pullback(g)
        _, opt_state = adam_step(net, grads, opt_state, self.adam_cfg,
                                 1.0 / cfg.batchSize)
        update_target(net, tgt, cfg.targetDelay, opt_state.step)

        with torch.no_grad():
            rs = write_back_with_next(rs, mb, rho, dkl, error, v, a_val,
                                      v_next)
            rs, frac_off = post_step_processing(rs, cfg, opt_state.step,
                                                error)
            metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                      error, v)
            metrics.update(grad_stats(grads))
        return params, opt_state, rs, metrics

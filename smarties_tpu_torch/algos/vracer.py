"""V-RACER: off-policy policy gradient with ReF-ER + Retrace.

Port of the zero-advantage continuous path of smarties_tpu/algos/
vracer.py — V-RACER = RACER<Zero_advantage, Continuous_policy>
(reference: Learners/RACER.{h,cpp}, RACER_common.cpp, RACER_train.cpp;
AlgoFactory.cpp:96-153). One network outputs [V | policy means] plus a
trainable state-independent stdev head (RACER_common.cpp:77-108).

A gradient step: sample a minibatch, one forward over [s_t; s_t1],
analytic output-space gradients (ReF-ER beta mix of the policy gradient
and the KL penalty, far-policy gated; RACER_train.cpp:14-67), pulled
back with autograd — `out.backward(gradient=[g; 0])`, so the s_t1 rows
get zero cotangent as under jax.vjp — then the Adam ascent step and the
in-place write-backs of rho/KL/TD-error into the replay. The output
gradient stays analytic, as the reference sets it on the output layer.

The Gaussian-advantage RACER, the discrete policies and recurrent nets
are not ported yet.
"""
from __future__ import annotations

import torch

from smarties_tpu_torch.algos.base import (default_metrics, gather_minibatch,
                                           grad_stats, post_step_processing,
                                           write_back_with_next)
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (NetSpec, apply_net, init_params,
                                           tree_leaves, tree_map)
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_init, adam_step)
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops.value_scale import scale_net2v, scale_vdiff
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters, anneal_rate


class VRacer:
    """V-RACER learner (continuous actions, zero advantage)."""

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters,
                 adv_kind: str | None = None):
        if mdp.is_discrete:
            raise NotImplementedError("discrete-action RACER is not ported")
        adv_kind = adv_kind or ("zero" if cfg.learner in ("VRACER", "default")
                                else "gaussian")
        if adv_kind != "zero":
            raise NotImplementedError(
                f"advantage {adv_kind!r}: only V-RACER (zero) is ported")
        if cfg.dataSamplingAlgo not in ("uniform", "default"):
            raise NotImplementedError(
                f"dataSamplingAlgo {cfg.dataSamplingAlgo!r}: only uniform "
                f"sampling is ported")
        if mdp.n_appended_obs or mdp.conv_layers:
            raise NotImplementedError("appended observations and conv "
                                      "inputs are not ported")
        self.mdp = mdp
        self.cfg = cfg
        self.adv_kind = adv_kind
        nA = mdp.dim_action
        self.nL = 0
        self.adv_start, self.pol_start = 1, 1
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        self.spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
            n_out=1 + nA, kind=cfg.nnType, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac,
            n_param_out=nA, param_init=tuple([sig0] * nA),
            out_bias_init=tuple([0.0] + [0.0] * nA))
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        self.returns_mode = ("retrace" if cfg.returnsEstimator
                             in ("default", "retrace")
                             else cfg.returnsEstimator)

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        params = init_params(gen, self.spec, device)
        return params, adam_init(params)

    # ------------------------------------------------------------------
    def _split_out(self, out):
        """-> (v_raw, adv_out, pol_out, sigma_raw)."""
        nA = self.mdp.dim_action
        v_raw = out[..., 0]
        adv = out[..., self.adv_start:self.adv_start + self.nL]
        pol = out[..., self.pol_start:self.pol_start + nA]
        sraw = out[..., self.pol_start + nA:self.pol_start + 2 * nA]
        return v_raw, adv, pol, sraw

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """Batched action selection (RACER::selectAction, RACER.cpp:31-47):
        forward, sample (train) or the clamped mean, record V and Q = V."""
        spec, mdp = self.spec, self.mdp
        share = mdp.n_agents_per_env if mdp.shared_noise else 1

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=()):
            out, rnn = apply_net(params, spec, obs_std, rnn)
            v_raw, _, pol, sraw = self._split_out(out)
            value = scale_net2v(v_raw)
            sigma = cp.sigma_of(sraw)
            bounded = mdp.consts(pol)[1]
            if train:
                a = cp.sample(gen, pol, sigma, bounded, share_agents=share)
            else:
                a = cp.eff_mean(pol, bounded)
            mu = cp.mu_vector(pol, sigma, bounded)
            return a, mu, value, torch.zeros_like(value), rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None):
        """One gradient step (RACER_train.cpp:14-67). Updates params, Adam
        moments and the replay in place; returns (params, opt_state, rs,
        metrics) with metrics as 0-d device tensors.

        sample_override: pinned (ep, t) sample indices (the trainer's
        presampled chunk, and the parity tests); otherwise `gen` draws
        them uniformly."""
        cfg, mdp, spec = self.cfg, self.mdp, self.spec
        if sample_override is not None:
            ep, t = sample_override
        else:
            ep, t = rb.sample_uniform(gen, rs, cfg.batchSize)
        mb = gather_minibatch(rs, ep, t)
        a_t, mu_t, qret_t = mb.action, mb.mu, mb.qret

        # ONE forward over [s_t; s_t1]: the t+1 values (V(s_T) refresh,
        # RACER_train.cpp:22-27) ride along; their rows get zero cotangent
        B2 = mb.s_t.shape[0]
        out_cat, _ = apply_net(params, spec, torch.cat([mb.s_t, mb.s_t1]))
        with torch.no_grad():
            out = out_cat[:B2].detach()
            out_next = out_cat[B2:].detach()
            v_raw, _, pol, sraw = self._split_out(out)
            v_val = scale_net2v(v_raw)
            bounded = mdp.consts(pol)[1]
            sigma = cp.sigma_of(sraw)
            rho = cp.imp_weight(a_t, pol, sigma, mu_t, bounded)
            dkl = cp.kl_div(mu_t, pol, sigma)
            a_val = torch.zeros_like(v_val)

            cmax, cinv, beta = rs.cmax_ret, rs.cinv_ret, rs.beta
            is_far = rb.is_far_policy(rho, cmax, cinv)
            a_ret = qret_t - v_val                  # Retrace advantage
            delta_q = a_ret - a_val                 # TD error
            ver = torch.minimum(torch.ones_like(rho), rho) * delta_q

            # ---- analytic output gradient (ascent), :46-57 ----
            zero = torch.zeros_like(v_val)
            g_v = torch.where(is_far, zero, ver * beta * scale_vdiff(v_raw))
            pg_coef = torch.where(is_far, zero,
                                  a_ret * torch.minimum(cmax, rho))
            pg_m, pg_s = cp.pol_grad(a_t, pol, sigma, sraw, pg_coef, bounded)
            far2 = is_far[:, None]
            pg_m = torch.where(far2, torch.zeros_like(pg_m), pg_m)
            pg_s = torch.where(far2, torch.zeros_like(pg_s), pg_s)
            pn_m, pn_s = cp.kl_grad(mu_t, pol, sigma, sraw,
                                    -torch.ones_like(pg_coef))
            g_pol = torch.cat([beta * pg_m + (1 - beta) * pn_m,
                               beta * pg_s + (1 - beta) * pn_s], dim=-1)
            g = torch.cat([g_v[:, None], g_pol], dim=-1)
            # invalid (empty-replay) samples contribute no gradient
            g = torch.where(mb.valid[:, None], g, torch.zeros_like(g))

        leaves = tree_leaves(params)
        for p in leaves:
            p.grad = None
        out_cat.backward(gradient=torch.cat([g, torch.zeros_like(g)]))
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = adam_step(params, grads, opt_state,
                                      self.adam_cfg, 1.0 / cfg.batchSize)

        with torch.no_grad():
            v_next = scale_net2v(out_next[..., 0])
            rs = write_back_with_next(rs, mb, rho, dkl, delta_q, v_val,
                                      a_val, v_next)
            rs, frac_off = post_step_processing(rs, cfg, opt_state.step,
                                                delta_q)
            metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta,
                                      delta_q, v_val)
            metrics.update(grad_stats(grads))
        return params, opt_state, rs, metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def refresh(self, rs: rb.ReplayState, n_grad_steps: float):
        """Every-1000-steps sweep (updateTrainingStatistics recompute
        branch + updateRewardsStats(.., rRateFac=10), Learner.cpp:74-100):
        returns recomputed with the OLD reward scaling, then the scaling
        updated."""
        cfg = self.cfg
        rs = rb.recompute_returns(rs, cfg.gamma, cfg.lambda_,
                                  self.returns_mode)
        lr = anneal_rate(cfg.learnrate, n_grad_steps, cfg.epsAnneal)
        return rb.update_state_rew_stats(rs, 10.0 * lr)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def initialize_stats(self, rs: rb.ReplayState):
        """At training start: exact state/reward stats from the gathered
        data, then all return estimators (Learner::initializeLearner,
        Learner.cpp:47-72)."""
        rs = rb.update_state_rew_stats(rs, 1.0, b_init=True)
        return rb.recompute_returns(rs, self.cfg.gamma, self.cfg.lambda_,
                                    self.returns_mode)

"""MixedPG: mixed stochastic + deterministic policy gradient.

Port of smarties_tpu/algos/mixedpg.py (reference: Learners/MixedPG.{h,cpp}):
an actor producing [policy mean, V head, (param) stdev] and a Q-critic
with the action as an extra input. The policy gradient mixes the
off-policy stochastic PG with the deterministic dQ/da gradient, weighted
per action dim by an EMA of 0.2 std(SPG_i) / rms(DPG_i)
(MixedPGstats::update); far-policy samples get asymmetric critic-error
gating; ReF-ER beta-mixes the KL penalty.

In place: the Adam step updates the leaves, so the bootstrap V(s_{t+1})
written back is computed before the step, from the pre-step weights the
JAX package reads; the two adaptive factors are updated in their own
storage too, as a captured step (runtime/graphs.py) needs.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from smarties_tpu_torch.algos.base import (Learner, check_ported,
                                           psum_grads_, returns_mode_of,
                                           step_tail_)
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (NetSpec, apply_net, init_params,
                                           tree_leaves, tree_map)
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_init, adam_step)
from smarties_tpu_torch.ops import advantages as adv_ops
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters

NN_EPS = float(np.finfo(np.float32).eps)


class MixedPGOptState(NamedTuple):
    adam: AdamState
    dpg_factor: torch.Tensor     # [nA] adaptive DPG mixing weight
    err_q_factor: torch.Tensor   # 0-d

    @property
    def step(self):
        return self.adam.step


class MixedPG(Learner):

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        if mdp.is_discrete:
            raise ValueError("MixedPG requires continuous actions")
        if cfg.nnType != "FFNN":
            # the JAX package's MixedPG has no BPTT window either
            raise ValueError(f"MixedPG has no recurrent path: nnType "
                             f"{cfg.nnType!r}")
        check_ported(mdp, cfg)
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        # actor outputs: [mean(nA), V(1)] + param stdev(nA)
        # (POL({0, nA+1}) in MixedPG.cpp:15)
        self.actor_spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
            n_out=nA + 1, act=cfg.nnFunc, out_prefac=cfg.outWeightsPrefac,
            n_param_out=nA, param_init=tuple([sig0] * nA))
        self.critic_spec = NetSpec(
            n_in=mdp.dim_net_input + nA, hidden=tuple(cfg.nnLayerSizes),
            n_out=1, act=cfg.nnFunc, out_prefac=cfg.outWeightsPrefac)
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        self.returns_mode = returns_mode_of(cfg, "retrace")

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        net = {"actor": init_params(gen, self.actor_spec, device),
               "critic": init_params(gen, self.critic_spec, device)}
        return net, MixedPGOptState(
            adam=adam_init(net),
            dpg_factor=torch.zeros((self.mdp.dim_action,),
                                   dtype=torch.float32, device=device),
            err_q_factor=torch.zeros((), dtype=torch.float32, device=device))

    def _actor(self, net, x):
        nA = self.mdp.dim_action
        out, _ = apply_net(net["actor"], self.actor_spec, x)
        return out[..., :nA], out[..., nA], out[..., nA + 1:]

    def _critic(self, net, x, a):
        q, _ = apply_net(net["critic"], self.critic_spec,
                         torch.cat([x, a], dim=-1))
        return q[..., 0]

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """act(params, obs_std, gen, rnn=(), noise=None); `noise` is the
        clipped-normal draw [V, nA] that replaces one from `gen`."""
        mdp = self.mdp
        sample = train and self.cfg.explNoise > 0

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=(), noise=None):
            mean, v_act, sraw = self._actor(params, obs_std)
            sigma = cp.sigma_of(sraw)
            bounded = mdp.consts(mean)[1]
            if not sample:
                a = cp.eff_mean(mean, bounded)
            elif noise is None:
                a = cp.sample(gen, mean, sigma, bounded)
            else:
                a = cp.sample_with_noise(noise, mean, sigma, bounded)
            mu = cp.mu_vector(mean, sigma, bounded)
            sval = self._critic(params, obs_std, mean)
            qval = self._critic(params, obs_std, a)
            # appendValues((sval + V)/2, qval + V/2 - sval/2)
            # (MixedPG.cpp:78-80)
            v_est = (sval + v_act) / 2
            return a, mu, v_est, qval + v_act / 2 - sval / 2 - v_est, rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: MixedPGOptState,
                   rs: rb.ReplayState, gen: torch.Generator | None = None,
                   sample_override=None, mesh=None):
        """MixedPG::Train (MixedPG.cpp:12-66). In place; returns (params,
        opt_state, rs, metrics)."""
        cfg = self.cfg
        mb = self.sample_minibatch(rs, gen, sample_override, mesh)

        # the ascent objective's forward, with grad: the critic at (s, a)
        # and at (s, mean) with the mean held constant
        m_g, v_g, sr_g = self._actor(params, mb.s_t)
        q_taken = self._critic(params, mb.s_t, mb.action)
        q_pol = self._critic(params, mb.s_t, m_g.detach())
        with torch.no_grad():
            mean, v_act, sraw = m_g.detach(), v_g.detach(), sr_g.detach()
            sigma = cp.sigma_of(sraw)
            bounded = self.mdp.consts(mean)[1]
            rho = cp.imp_weight(mb.action, mean, sigma, mb.mu, bounded)
            dkl = cp.kl_div(mb.mu, mean, sigma)
            is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
            far2 = is_far[:, None]
            beta = rs.beta
            zero = torch.zeros_like(rho)
            sval, qval = q_pol.detach(), q_taken.detach()
            # dQ/da at the policy mean, through the online critic
            critic_w = tree_map(lambda x: x.detach(), params)
            dpg, = adv_ops.per_sample_grad(
                lambda a, x: self._critic(critic_w, x, a), (mean, mb.s_t))

            a_est = qval - sval
            v_est = (sval + v_act) / 2
            q_ret = mb.qret
            a_ret = q_ret - v_est
            dq = q_ret - qval
            dv = v_act - sval

            # asymmetric far-policy gating (MixedPG.cpp:37-44)
            q_err = torch.where(is_far, zero, rho * dq)
            q_err = torch.where(is_far & (rho > 1) & (dq < 0),
                                torch.minimum(rs.cmax_ret, rho) * dq, q_err)
            q_err = torch.where(is_far & (rho < 1) & (dq > 0),
                                torch.maximum(rs.cinv_ret, rho) * dq, q_err)
            v_err = torch.where(is_far, zero, dv)
            v_err = torch.where(is_far & (rho > 1) & (dv > 0), dv, v_err)
            v_err = torch.where(is_far & (rho < 1) & (dv < 0), dv, v_err)

            # stochastic PG + adaptive deterministic mix (MixedPG.cpp:46-55)
            pg_coef = torch.where(is_far, zero, a_ret * rho)
            spg_m, spg_s = cp.pol_grad(mb.action, mean, sigma, sraw, pg_coef,
                                       bounded)
            f = torch.where(torch.abs(v_err) < NN_EPS, zero, 1.0 / v_err)
            dpg_n = torch.where(far2, torch.zeros_like(dpg),
                                dpg * (v_err * f)[:, None])
            mix_m = spg_m + dpg_n * opt_state.dpg_factor[None, :]
            pn_m, pn_s = cp.kl_grad(mb.mu, mean, sigma, sraw,
                                    -torch.ones_like(rho))
            g_m = beta * mix_m + (1 - beta) * pn_m
            g_s = beta * spg_s + (1 - beta) * pn_s
            v_actor_err = torch.where(
                is_far, zero,
                beta * torch.minimum(torch.ones_like(rho), rho)
                * (q_ret - a_est - v_act))

            # bootstrap from the pre-step weights
            m1, vn, _ = self._actor(params, mb.s_t1)
            v_next = (self._critic(params, mb.s_t1, m1) + vn) / 2

        # actor gets [g_m, v_actor_err, g_s]; the critic q_err at (s, a)
        # and v_err at (s, mean). g_s is d/d(raw stdev output): pol_grad
        # and kl_grad already chain the SoftPlus.
        objective = (torch.sum(g_m * m_g) + torch.sum(g_s * sr_g)
                     + torch.sum(v_actor_err * v_g)
                     + torch.sum(q_err * q_taken) + torch.sum(v_err * q_pol))
        for p in tree_leaves(params):
            p.grad = None
        objective.backward()
        grads = psum_grads_(tree_map(lambda p: p.grad, params), mesh)
        adam_step(params, grads, opt_state.adam, self.adam_cfg,
                  1.0 / cfg.batchSize)

        with torch.no_grad():
            # adaptive DPG weight EMA (MixedPGstats::update), in place
            lr = cfg.learnrate
            std_spg = torch.sqrt(torch.clamp(
                torch.mean(spg_m ** 2, 0) - torch.mean(spg_m, 0) ** 2,
                min=0.0))
            rms_dpg = torch.sqrt(torch.mean(dpg_n ** 2, 0) + NN_EPS)
            opt_state.dpg_factor.add_(
                lr * (0.2 * std_spg / rms_dpg - opt_state.dpg_factor))
            opt_state.err_q_factor.add_(
                lr * (torch.mean(dq * dq) - opt_state.err_q_factor))

            delta = a_ret - a_est
            rs, metrics = step_tail_(rs, mb, cfg, opt_state.step, grads, rho,
                                     dkl, delta, v_est, a_est, v_next,
                                     is_far, mesh)
        return params, opt_state, rs, metrics

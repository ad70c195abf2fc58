"""DQN with a Boltzmann (soft) policy and optional ReF-ER + Retrace.

Port of smarties_tpu/algos/dqn.py (reference: Learners/DQN.cpp, compiled
with DQN_USE_POLICY): the Q-network doubles as an Exp-normalized
categorical policy over the raw Q values, which gives importance weights
and ReF-ER; 1-step double-Q targets with a Polyak or periodic target net
(DQN.cpp:173-185), or Retrace targets when returnsEstimator != none
(DQN.cpp:161-171). `dqnEpsGreedy` selects the eps-greedy branch.

Deviation from the reference, kept from the JAX package: the 1-step
target uses r_{t+1}, the reward of the transition being learned, where
the reference reads r_t (DQN.cpp:174, an off-by-one).

params = {"net", "tgt"}; the target leaves do not require grad and are
updated in place (models/optim.py::update_target).

A recurrent nnType carries the recurrence in the single net: the online
and the target net both run the truncated-BPTT window (algos/base.py).
"""
from __future__ import annotations

import torch

from smarties_tpu_torch.algos.base import (Learner, backprop, bptt_window,
                                           check_ported, psum_grads_,
                                           returns_mode_of, seq_forward_vjp,
                                           seq_outputs, step_tail_,
                                           target_copy)
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (Conv2DDesc, NetSpec, apply_net,
                                           init_carry, init_params)
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_init, adam_step,
                                             update_target)
from smarties_tpu_torch.ops import discrete_policy as dpol
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters


def _soft_expected_value(q_hat, q_tilde):
    """E_{pol(q_hat)}[q_tilde], pol the Exp-normalized policy over q_hat
    (expectedValue, DQN.cpp:16-30, DQN_USE_POLICY branch)."""
    _, _, probs = dpol.probs_of(q_hat, fn="exp")
    return torch.sum(probs * q_tilde, dim=-1)


def _greedy_expected_value(q_hat, q_tilde):
    """q_tilde[argmax q_hat] (expectedValue, DQN.cpp:36: double-Q)."""
    idx = torch.argmax(q_hat, dim=-1, keepdim=True)
    return torch.gather(q_tilde, -1, idx)[..., 0]


class DQN(Learner):

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        if not mdp.is_discrete:
            raise ValueError("DQN requires discrete actions")
        check_ported(mdp, cfg, frames=True)
        self.mdp = mdp
        self.cfg = cfg
        self.n_appended = mdp.n_appended_obs
        # Boltzmann-over-Q + ReF-ER (the reference's compiled default) or
        # the eps-greedy branch with constant eps = explNoise
        self.eps_greedy = bool(cfg.dqnEpsGreedy)
        self.n_opts = mdp.max_action_label
        self.spec = NetSpec(
            n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
            conv=tuple(Conv2DDesc(*c) for c in mdp.conv_layers),
            n_out=self.n_opts, kind=cfg.nnType, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac,
            compute_dtype="bfloat16" if cfg.nnBf16 else "float32")
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        # the factory default estimator for DQN is "none"
        self.returns_mode = returns_mode_of(cfg, "none")
        self.use_retrace = self.returns_mode != "none"
        self.use_target = cfg.targetDelay > 0

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        net = init_params(gen, self.spec, device)
        return {"net": net, "tgt": target_copy(net)}, adam_init(net)

    def init_rnn(self, n_envs: int, device=None):
        """Per-env acting carry: the net's recurrent state, () for FFNN."""
        return init_carry(self.spec, (n_envs,), device)

    def _value(self, qs):
        return (_greedy_expected_value(qs, qs) if self.eps_greedy
                else _soft_expected_value(qs, qs))

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """act(params, obs_std, gen, rnn=(), noise=None) -> (label [V, 1],
        probs, E[Q], Q[a] - E[Q], rnn); `noise` is the uniform [V] that
        replaces the draw from `gen`."""
        spec = self.spec
        sample = train and self.cfg.explNoise > 0
        eps, nA = float(self.cfg.explNoise), self.n_opts

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=(), noise=None):
            qs, rnn = apply_net(params["net"], spec, obs_std, rnn)
            if self.eps_greedy:
                greedy = dpol.one_hot(torch.argmax(qs, dim=-1), nA,
                                      qs.dtype)
                probs = eps / nA + (1.0 - eps) * greedy
            else:
                _, _, probs = dpol.probs_of(qs, fn="exp")
            opt = dpol.select(gen, probs, sample, u=noise)
            q_a = torch.gather(qs, -1, opt[..., None])[..., 0]
            value = self._value(qs)
            # appendValues(E[Q], Q[a]) => advantage = Q[a] - E[Q]
            return opt[..., None].to(qs.dtype), probs, value, q_a - value, \
                rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None,
                   mesh=None):
        """DQN::Train (DQN.cpp:150-211). In place; returns (params,
        opt_state, rs, metrics)."""
        cfg, spec = self.cfg, self.spec
        mb = self.sample_minibatch(rs, gen, sample_override, mesh)
        net, tgt = params["net"], params["tgt"]
        if spec.is_recurrent:
            xs, active = bptt_window(rs, mb.ep, mb.t, cfg.nnBPTTseq)
            qs, q_hat_next, pullback = seq_forward_vjp(net, spec, xs,
                                                       active)
        else:
            qs_g, _ = apply_net(net, spec, mb.s_t)
            qs = qs_g.detach()
            with torch.no_grad():
                q_hat_next, _ = apply_net(net, spec, mb.s_t1)

            def pullback(g):
                return backprop(net, qs_g, g)

        with torch.no_grad():
            opt = mb.action[..., 0].long()
            q_a = torch.gather(qs, -1, opt[:, None])[..., 0]
            exp_val = (_greedy_expected_value if self.eps_greedy
                       else _soft_expected_value)
            if self.use_retrace:
                td_error = mb.qret - q_a
            else:
                if not self.use_target:
                    q_tilde_next = q_hat_next
                elif spec.is_recurrent:
                    q_tilde_next = seq_outputs(tgt, spec, xs, active)[1]
                else:
                    q_tilde_next = apply_net(tgt, spec, mb.s_t1)[0]
                # double-Q: select with the online net, evaluate with target
                boot = exp_val(q_hat_next, q_tilde_next)
                target = mb.reward_next + torch.where(
                    mb.terminal_next, torch.zeros_like(boot),
                    cfg.gamma * boot)
                td_error = target - q_a
            v_next = exp_val(q_hat_next, q_hat_next)
            g = dpol.one_hot(opt, self.n_opts, qs.dtype) * td_error[:, None]
            if self.eps_greedy:
                # the non-policy branch writes rho = 1, dkl = 0 and skips
                # ReF-ER (DQN.cpp:204-205)
                rho = torch.ones_like(td_error)
                dkl = torch.zeros_like(td_error)
                is_far = torch.zeros_like(rho, dtype=torch.bool)
            else:
                # ReF-ER on the Boltzmann policy (DQN.cpp:192-204)
                un, norm, probs = dpol.probs_of(qs, fn="exp")
                rho = dpol.imp_weight(opt, probs, mb.mu)
                dkl = dpol.kl_mu_pi(mb.mu, probs)
                if cfg.clipImpWeight > 0:
                    is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
                    g = torch.where(is_far[:, None], torch.zeros_like(g), g)
                    pen_g = dpol.kl_grad(mb.mu, qs, un, norm, probs,
                                         -torch.ones_like(rho), fn="exp")
                    g = rs.beta * g + (1 - rs.beta) * pen_g
                else:
                    is_far = torch.zeros_like(rho, dtype=torch.bool)
            v_val = self._value(qs)

        grads = psum_grads_(pullback(g), mesh)
        _, opt_state = adam_step(net, grads, opt_state, self.adam_cfg,
                                 1.0 / cfg.batchSize)
        update_target(net, tgt, cfg.targetDelay, opt_state.step)

        with torch.no_grad():
            rs, metrics = step_tail_(rs, mb, cfg, opt_state.step, grads, rho,
                                     dkl, td_error, v_val, q_a - v_val,
                                     v_next, is_far, mesh)
        return params, opt_state, rs, metrics

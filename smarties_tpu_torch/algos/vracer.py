"""RACER / V-RACER: off-policy policy gradient with ReF-ER + Retrace.

Port of smarties_tpu/algos/vracer.py (reference:
Learners/RACER.{h,cpp}, RACER_common.cpp, RACER_train.cpp) for the three
factory instantiations (AlgoFactory.cpp:96-153):

- V-RACER   = RACER<Zero_advantage, Continuous_policy> (A == 0, Q == V)
- RACER     = RACER<Gaussian_advantage, Continuous_policy>
- RACER-dis = RACER<Discrete_advantage, Discrete_policy>; V-RACER on a
  discrete MDP is rewritten to it (AlgoFactory.cpp:78-83).

One network outputs [V | advantage params | policy params], plus a
trainable state-independent stdev head for continuous policies
(RACER_common.cpp:77-108).

A gradient step: sample a minibatch, one forward over [s_t; s_t1],
analytic output-space gradients (ReF-ER beta mix of the policy gradient
and the KL penalty, far-policy gated; RACER_train.cpp:14-67), pulled
back with autograd — `out.backward(gradient=[g; 0])`, so the s_t1 rows
get zero cotangent as under jax.vjp — then the Adam ascent step and the
in-place write-backs of rho/KL/TD-error into the replay. The output
gradient stays analytic, as the reference sets it on the output layer;
only the advantage-head rows come from autograd
(ops/advantages.py::per_sample_grad).

With a recurrent nnType the forward is a truncated-BPTT window of
nnBPTTseq steps ending at the sampled step (algos/base.py): the output at
t takes the gradient, which is pulled back through the window, and the
output at t+1 gives the V(s_T) refresh. Acting threads the net's carry.
The recurrent step and the acting carry are captured as the feed-forward
ones are (`captures_bptt`; runtime/trainer.py).
"""
from __future__ import annotations

import torch

from smarties_tpu_torch.algos.base import (Learner, backprop, bptt_counts,
                                           bptt_window, check_ported,
                                           psum_grads_, returns_mode_of,
                                           seq_forward_vjp, step_tail_)
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (Conv2DDesc, NetSpec, apply_net,
                                           init_carry, init_params)
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_init, adam_step)
from smarties_tpu_torch.ops import advantages as adv_ops
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops import discrete_policy as dpol
from smarties_tpu_torch.ops import policy_head_kernel
from smarties_tpu_torch.ops.stamp import on_grad
from smarties_tpu_torch.ops.value_scale import scale_net2v, scale_vdiff
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters


# the traced step's phases of a feed-forward net with a conv stack
CONV_STEP_PHASES = ("gather", "conv_forward", "forward", "backward",
                    "conv_backward", "adam", "writeback")
# and of a recurrent net: the window's forward (to the output at t, with
# the no-grad step to t+1), the head (output_grad) and the pullback
# through the window
RNN_STEP_PHASES = ("gather", "bptt_forward", "head", "bptt_backward",
                   "adam", "writeback")


class VRacer(Learner):
    """RACER family learner. adv_kind selects the advantage family; the
    default follows the factory rules from cfg.learner."""
    captures_bptt = True

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters,
                 adv_kind: str | None = None):
        check_ported(mdp, cfg, frames=True)
        self.mdp = mdp
        self.cfg = cfg
        self.n_appended = mdp.n_appended_obs
        self.discrete = mdp.is_discrete
        nA = mdp.dim_action
        if adv_kind is None:
            if self.discrete:
                adv_kind = "discrete"    # AlgoFactory.cpp:78-83 rewrite
            else:
                adv_kind = ("zero" if cfg.learner in ("VRACER", "default")
                            else "gaussian")
        self.adv_kind = adv_kind
        common = dict(n_in=mdp.dim_net_input, hidden=tuple(cfg.nnLayerSizes),
                      conv=tuple(Conv2DDesc(*c) for c in mdp.conv_layers),
                      kind=cfg.nnType, act=cfg.nnFunc,
                      out_prefac=cfg.outWeightsPrefac,
                      compute_dtype="bfloat16" if cfg.nnBf16 else "float32")
        if self.discrete:
            self.n_opts = mdp.max_action_label
            self.nL = adv_ops.discrete_n_outputs(self.n_opts)
            # outputs: [V, adv(nOpts), pol(nOpts)] (RACER_common.cpp:121-123)
            self.spec = NetSpec(n_out=1 + self.nL + self.n_opts, **common)
        else:
            self.nL = (0 if adv_kind == "zero"
                       else adv_ops.gaussian_n_outputs(nA))
            sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
            bias = [0.0] + (adv_ops.gaussian_initial_bias(nA)
                            if self.nL else []) + [0.0] * nA
            self.spec = NetSpec(
                n_out=1 + self.nL + nA, n_param_out=nA,
                param_init=tuple([sig0] * nA), out_bias_init=tuple(bias),
                **common)
        self.adv_start, self.pol_start = 1, 1 + self.nL
        if self.spec.is_recurrent:
            self.step_phases = RNN_STEP_PHASES
        elif self.spec.conv:
            self.step_phases = CONV_STEP_PHASES
        self.adam_cfg = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                   eps_anneal=cfg.epsAnneal)
        self.returns_mode = returns_mode_of(cfg, "retrace")

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        params = init_params(gen, self.spec, device)
        return params, adam_init(params)

    def init_rnn(self, n_envs: int, device=None):
        """Per-env acting carry: the net's recurrent state, () for FFNN."""
        return init_carry(self.spec, (n_envs,), device)

    # ------------------------------------------------------------------
    def _split_out(self, out):
        """-> (v_raw, adv_out, pol_out, sigma_raw or None)."""
        v_raw = out[..., 0]
        adv = out[..., self.adv_start:self.adv_start + self.nL]
        if self.discrete:
            pol = out[..., self.pol_start:self.pol_start + self.n_opts]
            return v_raw, adv, pol, None
        nA = self.mdp.dim_action
        pol = out[..., self.pol_start:self.pol_start + nA]
        sraw = out[..., self.pol_start + nA:self.pol_start + 2 * nA]
        return v_raw, adv, pol, sraw

    def _advantage(self, adv_out, action_or_opt, pol, sigma=None,
                   probs=None):
        """A(s, a) for the configured family."""
        if self.adv_kind == "zero":
            return torch.zeros(adv_out.shape[:-1], dtype=pol.dtype,
                               device=pol.device)
        if self.discrete:
            return adv_ops.discrete_advantage(adv_out, action_or_opt, probs)
        m_eff = cp.eff_mean(pol, self.mdp.consts(pol)[1])
        return adv_ops.gaussian_advantage(adv_out, action_or_opt, m_eff,
                                          sigma * sigma)

    # ------------------------------------------------------------------
    def output_grad(self, out, mb, rs):
        """The head after the forward: from the net's outputs at the
        sampled rows to the analytic output gradient (ascent) that the
        pullback receives -> (g, rho, dkl, delta_q, v_val, a_val, is_far).
        CUDA tensors of V-RACER's continuous head (the zero advantage)
        take the hand-written kernel (ops/policy_head_kernel.py: one
        launch, bit-equal); the CPU, RACER's Gaussian advantage and the
        discrete head take the chain (output_grad_plain)."""
        if out.is_cuda and not self.discrete and self.adv_kind == "zero":
            return policy_head_kernel.continuous_head(
                out, mb.action, mb.mu, mb.qret, mb.valid,
                self.mdp.consts(out)[1], rs.cmax_ret, rs.cinv_ret, rs.beta)
        return self.output_grad_plain(out, mb, rs)

    def output_grad_plain(self, out, mb, rs):
        """output_grad as PyTorch ops (RACER_train.cpp:14-57): V, rho, the
        KL, the far-policy flags and the TD error of the sampled rows, then
        the ReF-ER beta mix of the policy gradient and the KL penalty, far-
        policy gated, with the advantage head's rows where there is one;
        invalid rows get no gradient."""
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

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """Batched action selection (RACER::selectAction, RACER.cpp:31-47):
        forward, sample (train) or the mode, record V and Q = V + A(a).

        act(params, obs_std, gen, rnn=(), noise=None): `noise` replaces
        the draw from `gen` — clipped normals [V, nA] (continuous) or
        uniforms [V] (discrete) — so a test can pin it."""
        spec, mdp = self.spec, self.mdp
        share = mdp.n_agents_per_env if mdp.shared_noise else 1

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=(), noise=None):
            out, rnn = apply_net(params, spec, obs_std, rnn)
            v_raw, adv_out, pol, sraw = self._split_out(out)
            value = scale_net2v(v_raw)
            if self.discrete:
                _, _, probs = dpol.probs_of(pol)
                opt = dpol.select(gen, probs, train, u=noise)
                a_val = self._advantage(adv_out, opt, pol, probs=probs)
                return opt[..., None].to(value.dtype), probs, value, a_val, \
                    rnn
            sigma = cp.sigma_of(sraw)
            bounded = mdp.consts(pol)[1]
            if not train:
                a = cp.eff_mean(pol, bounded)
            elif noise is None:
                a = cp.sample(gen, pol, sigma, bounded, share_agents=share)
            else:
                a = cp.sample_with_noise(noise, pol, sigma, bounded)
            mu = cp.mu_vector(pol, sigma, bounded)
            return a, mu, value, self._advantage(adv_out, a, pol, sigma), rnn

        return act

    # ------------------------------------------------------------------
    # the phases of a traced step, stamped at their ends by `stamp`; a
    # feed-forward net with a conv stack has CONV_STEP_PHASES
    step_phases = ("gather", "forward", "backward", "adam", "writeback")

    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None,
                   mesh=None, stamp=None):
        """One gradient step (RACER_train.cpp:14-67). Updates params, Adam
        moments and the replay in place; returns (params, opt_state, rs,
        metrics) with metrics as 0-d device tensors.

        sample_override: pinned (ep, t) sample indices (the trainer's
        presampled chunk, and the parity tests); otherwise `gen` draws
        them uniformly.

        mesh: this rank's LearnerMesh (parallel/mesh.py). The rank draws
        batchSize // K samples from its replay shard, the gradient is
        summed across ranks before Adam (the reference's MPI_Iallreduce,
        Optimizer.cpp:110-119), and the ReF-ER counts and metrics are
        global.

        stamp: the traced step's phase stamps (runtime/trainer.py):
        stamp(name) marks the end of the phase `name` of step_phases in
        stream order; the caller stamps the start and the end of the last
        phase. With a conv stack, conv_forward ends where the stack's
        output enters the dense layers, backward where the backward pass
        reaches that output again, and conv_backward with the stack's
        gradients; stamp.counters["conv_macs"] gets the multiply-adds of
        each conv of the forward, from the shapes it ran. With a
        recurrent net the phases are RNN_STEP_PHASES, and
        stamp.counters gets the window's bptt_cells and bptt_macs
        (algos/base.py::bptt_counts)."""
        cfg, spec = self.cfg, self.spec
        mb = self.sample_minibatch(rs, gen, sample_override, mesh)
        last_grads = "backward"         # the phase that ends with the grads

        if spec.is_recurrent:
            xs, active = bptt_window(rs, mb.ep, mb.t, cfg.nnBPTTseq)
            if stamp is not None:
                stamp("gather")
                stamp.counters.update(bptt_counts(spec, xs))
            out, out_next, pullback = seq_forward_vjp(params, spec, xs,
                                                      active)
            if stamp is not None:
                stamp("bptt_forward")
            last_grads = "bptt_backward"
        else:
            if stamp is not None:
                stamp("gather")
            # ONE forward over [s_t; s_t1]: the t+1 values (V(s_T)
            # refresh, RACER_train.cpp:22-27) ride along; their rows get
            # zero cotangent
            B2 = mb.s_t.shape[0]
            boundary = None
            if stamp is not None and spec.conv:
                last_grads = "conv_backward"

                def boundary(h, macs):
                    stamp("conv_forward")
                    stamp.counters["conv_macs"] = macs
                    return on_grad(h, lambda: stamp("backward"))
            out_cat, _ = apply_net(params, spec,
                                   torch.cat([mb.s_t, mb.s_t1]),
                                   conv_boundary=boundary)
            out = out_cat[:B2].detach()
            out_next = out_cat[B2:].detach()

            def pullback(g):
                return backprop(params, out_cat,
                                torch.cat([g, torch.zeros_like(g)]))

        with torch.no_grad():
            g, rho, dkl, delta_q, v_val, a_val, is_far = self.output_grad(
                out, mb, rs)

        if stamp is not None:
            stamp("head" if spec.is_recurrent else "forward")
        grads = psum_grads_(pullback(g), mesh)
        if stamp is not None:
            stamp(last_grads)
        params, opt_state = adam_step(params, grads, opt_state,
                                      self.adam_cfg, 1.0 / cfg.batchSize)
        if stamp is not None:
            stamp("adam")

        with torch.no_grad():
            rs, metrics = step_tail_(rs, mb, cfg, opt_state.step, grads, rho,
                                     dkl, delta_q, v_val, a_val,
                                     out_next[..., 0], is_far, mesh,
                                     net2v=True)
        return params, opt_state, rs, metrics


class Racer(VRacer):
    """Full RACER: the Gaussian advantage for continuous actions, the
    discrete advantage for discrete ones."""

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        super().__init__(mdp, cfg, adv_kind="discrete" if mdp.is_discrete
                         else "gaussian")

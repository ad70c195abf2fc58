"""ACER: actor-critic with experience replay over episode windows.

Port of smarties_tpu/algos/acer.py (reference: Learners/ACER.{h,cpp}):
episode-sampled training over windows of up to SEQ_CUTOFF = 200 steps;
three heads over an optional shared encoder — the actor (mean + a
state-independent stdev head, with a target actor), the V critic and an
advantage net that takes the action as input (both critics at 10x the
learning rate, ACER.cpp:200-202); truncated importance sampling with bias
correction from 5 on-policy expectation samples, a trust-region
projection of the policy gradient against KL(pi || pi_tgt), and the
"soft" Retrace recursion Q_RET with c = min(1, rho)^(1/sqrt(nA)).

A gradient step gathers [B, S+1] windows, runs the heads over them under
one autograd graph (the 5 expectation samples and the on-policy sample
go through ONE forward of the advantage net, [7, B, S+1, F+nA] with the
features broadcast), computes the analytic output gradients and pulls
them back with one backward call.

The two backward recursions (ACER.cpp:57-76; a lax.scan over S steps in
the JAX package) are affine in Q_RET / Q_OPC given the forwards: with
the scan's output at s being the carry BEFORE step s is applied,
    Q[s] = a[s] + b[s] Q[s+1],
    a[s] = r[s+1] + gamma (v[s+1] - c[s+1] qtheta[s+1]),  b[s] = gamma c[s+1]
for s < nsteps-1, a = q_boot and b = 0 at s = nsteps-1, a = b = 0
beyond; Q_OPC has c == 1. Both rows of every window go through ONE call
of kernel K1's `affine_suffix_scan` (ops/retrace_kernel.py) on [2B, S]
coefficients: one kernel launch per grad step on the card, the plain
loop on the CPU. b Q replaces c (Q - qtheta), which reassociates the
arithmetic (about 1e-6 relative off the scan).

The window write-back scatters rho, KL, TD error, V and the stored
advantage qtheta - V into the replay. Positions past a window's end
(the JAX package drops them at a trash index) are redirected to the
window's last step with its values, so a step written twice gets one
value whatever the order of the index writes.
"""
from __future__ import annotations

import numpy as np
import torch

from smarties_tpu_torch.algos.base import (Learner, backprop, check_ported,
                                           default_metrics, grad_stats,
                                           local_batch, post_step_processing,
                                           psum_grads_, returns_mode_of,
                                           target_copy)
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import NetSpec, apply_net, init_params
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_advance_, adam_init,
                                             adam_update_, update_target)
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops.retrace_kernel import affine_suffix_scan
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters

F32 = torch.float32
SEQ_CUTOFF = 200           # ACER.cpp:11
N_EXPECTATION = 5          # ACER.h:24
CRITICS = ("value", "advtg")


def window_coeffs(r_scaled, v, q_theta, c, nsteps, q_boot, gamma: float):
    """Coefficients (a, b) [B, S] of the recursion Q[s] = a[s] + b[s]
    Q[s+1] from [B, S+1] window arrays (see the module docstring)."""
    S = r_scaled.shape[1] - 1
    s = torch.arange(S, device=r_scaled.device)[None, :]
    last = s == (nsteps[:, None] - 1)
    on = s < (nsteps[:, None] - 1)
    a = r_scaled[:, 1:] + gamma * (v[:, 1:] - c[:, 1:] * q_theta[:, 1:])
    b = gamma * c[:, 1:]
    zero = torch.zeros_like(a)
    a = torch.where(on, a, torch.where(last, q_boot[:, None], zero))
    b = torch.where(on, b, zero)
    return a, b


class ACER(Learner):
    # draws are hoisted through presample_fn on one rank; under a mesh
    # each step draws its own, as in the JAX package (whose sharded chunk
    # checks `presample` only, parallel/mesh.py:91-92)
    presample = False
    # its window draw and recursions run eagerly (not held under capture)
    capturable = False

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        if mdp.is_discrete:
            raise ValueError("ACER is implemented for continuous actions")
        check_ported(mdp, cfg)
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        self.acer_trick_pow = 1.0 / np.sqrt(nA)   # ACER.h:22
        enc_sizes = tuple(s for s in cfg.encoderLayerSizes if s > 0)
        self.has_enc = len(enc_sizes) > 0
        feat = enc_sizes[-1] if self.has_enc else mdp.dim_net_input
        if self.has_enc:
            self.enc_spec = NetSpec(
                n_in=mdp.dim_net_input, hidden=enc_sizes[:-1],
                n_out=enc_sizes[-1], kind="FFNN", act=cfg.nnFunc,
                out_prefac=1.0, out_act=cfg.nnFunc)
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        # feed-forward heads whatever nnType says, as in the JAX package
        head = dict(hidden=tuple(cfg.nnLayerSizes), kind="FFNN",
                    act=cfg.nnFunc, out_prefac=cfg.outWeightsPrefac)
        self.actor_spec = NetSpec(n_in=feat, n_out=nA, n_param_out=nA,
                                  param_init=tuple([sig0] * nA), **head)
        self.value_spec = NetSpec(n_in=feat, n_out=1, **head)
        self.advtg_spec = NetSpec(n_in=feat + nA, n_out=1, **head)
        self.actor_adam = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                     eps_anneal=cfg.epsAnneal)
        self.critic_adam = AdamConfig(eta=10 * cfg.learnrate,
                                      lambda_=cfg.nnLambda,
                                      eps_anneal=cfg.epsAnneal)
        self.returns_mode = returns_mode_of(cfg, "none")

    # ------------------------------------------------------------------
    def presample_fn(self, gen, rs: rb.ReplayState, batch: int, n: int):
        """A chunk's draws up front: episodes uniform over the stored ones
        and a raw window start in [0, 2^30) per sample -> (ep [n, B],
        tst [n, B]). The start is reduced modulo the episode's length
        inside the step, where the lengths are current (they change only
        at commits, never inside a chunk)."""
        ep = rb.sample_episodes(gen, rs, n * batch).reshape(n, batch)
        tst = torch.randint(0, 2 ** 30, (n, batch), generator=gen,
                            device=ep.device)
        return ep, tst

    def init(self, gen: torch.Generator, device=None):
        net = {"actor": init_params(gen, self.actor_spec, device),
               "value": init_params(gen, self.value_spec, device),
               "advtg": init_params(gen, self.advtg_spec, device)}
        if self.has_enc:
            net["enc"] = init_params(gen, self.enc_spec, device)
        return ({"net": net, "tgt_actor": target_copy(net["actor"])},
                adam_init(net))

    def _feat(self, net, x):
        if self.has_enc:
            return apply_net(net["enc"], self.enc_spec, x)[0]
        return x

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """act(params, obs_std, gen, rnn=(), noise=None) -> (action, mu,
        0, 0, rnn): sample (train) or the mode. `noise` replaces the
        clipped normals drawn from `gen`."""
        sample = train and self.cfg.explNoise > 0
        nA = self.mdp.dim_action

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=(), noise=None):
            net = params["net"]
            out, _ = apply_net(net["actor"], self.actor_spec,
                               self._feat(net, obs_std))
            mean, sigma = out[..., :nA], cp.sigma_of(out[..., nA:])
            bounded = self.mdp.consts(mean)[1]
            if not sample:
                a = cp.eff_mean(mean, bounded)
            elif noise is None:
                a = cp.sample(gen, mean, sigma, bounded)
            else:
                a = cp.sample_with_noise(noise, mean, sigma, bounded)
            zeros = torch.zeros(mean.shape[:-1], dtype=F32,
                                device=mean.device)
            return a, cp.mu_vector(mean, sigma, bounded), zeros, zeros, rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None,
                   noise=None, mesh=None):
        """ACER::Train (ACER.cpp:16-108). Updates params, Adam moments,
        the target actor and the replay in place; returns (params,
        opt_state, rs, metrics).

        sample_override: pinned (ep, tst_raw) [B] (presample_fn's draw,
        the parity tests); noise: (noise_pol [B, S+1, nA], noise_ext [5,
        B, S+1, nA]) clipped normals; otherwise `gen` draws them. mesh:
        this rank draws batchSize // K windows from its shard; the
        gradient, the ReF-ER counts and the metrics are global."""
        cfg = self.cfg
        nA = self.mdp.dim_action
        S = min(SEQ_CUTOFF, rs.max_len)
        B = local_batch(cfg, mesh)
        gamma = cfg.gamma
        dev = rs.slot_len.device
        if sample_override is not None:
            ep, tst_raw = sample_override
        else:
            ep = rb.sample_episodes(gen, rs, B)
            tst_raw = torch.randint(0, 2 ** 30, (B,), generator=gen,
                                    device=dev)
        epl = ep.long()
        ndata = torch.clamp(rs.slot_len[epl].long(), min=1)
        tst = tst_raw.long() % ndata
        tstart = torch.minimum(tst, torch.clamp(ndata - S, min=0))
        tend = torch.minimum(ndata, tstart + S)
        nsteps = tend - tstart                                # [B]

        # window gather: positions tstart + w, w in 0..S (S: the bootstrap
        # state at tend)
        w = torch.arange(S + 1, device=dev)
        twc = torch.clamp(tstart[:, None] + w[None, :], max=rs.max_len)
        active = w[None, :] < nsteps[:, None]                # [B, S+1]
        idx = (twc, epl[:, None])
        xs = (rs.states_tm[idx] - rs.state_mean) * rs.state_scale
        acts = rs.actions_tm[idx]
        # padded positions hold zero vectors: a zero stdev there would put
        # inf/NaN into log-probabilities before any mask could help
        safe_mu = torch.cat([torch.zeros(nA, dtype=F32, device=dev),
                             torch.ones(nA, dtype=F32, device=dev)])
        mus = torch.where(active[..., None], rs.mus_tm[idx], safe_mu)
        rho_old = rs.rho_tm[idx]
        r_scaled = (rs.rewards_tm[idx] - rs.rew_mean) * rs.rew_scale
        net, tgt_actor = params["net"], params["tgt_actor"]
        bounded = self.mdp.consts(xs)[1]

        if noise is None:
            noise = (cp.clipped_normal(gen, (B, S + 1, nA), xs),
                     cp.clipped_normal(gen, (N_EXPECTATION, B, S + 1, nA),
                                       xs))
        noise_pol, noise_ext = noise

        # ---- the heads, under one autograd graph ----
        feat = self._feat(net, xs)                           # [B, S+1, F]
        pout, _ = apply_net(net["actor"], self.actor_spec, feat)
        vout, _ = apply_net(net["value"], self.value_spec, feat)
        with torch.no_grad():
            mean, sraw = pout[..., :nA].detach(), pout[..., nA:].detach()
            sigma = cp.sigma_of(sraw)
            pol_samp = cp.sample_with_noise(noise_pol, mean, sigma, bounded)
            ext_samp = cp.sample_with_noise(noise_ext, mean[None],
                                            sigma[None], bounded)
        # the advantage net on [taken; on-policy sample; 5 expectation
        # samples] in one forward, the features broadcast
        a_in = torch.cat([acts[None], pol_samp[None], ext_samp])
        aout, _ = apply_net(
            net["advtg"], self.advtg_spec,
            torch.cat([feat[None].expand((N_EXPECTATION + 2,)
                                         + tuple(feat.shape)), a_in], -1))

        with torch.no_grad():
            v_st = vout[..., 0].detach()
            a_all = aout[..., 0].detach()
            a_taken, a_pol = a_all[0], a_all[1]
            a_ext_mean = torch.mean(a_all[2:], dim=0)
            tgt_out, _ = apply_net(tgt_actor, self.actor_spec, feat.detach())
            tgt_mu = cp.mu_vector(tgt_out[..., :nA],
                                  cp.sigma_of(tgt_out[..., nA:]), bounded)
            q_theta = v_st + a_taken - a_ext_mean
            a_pol_c = a_pol - a_ext_mean
            one = torch.ones_like(v_st)
            rho = torch.where(active,
                              cp.imp_weight(acts, mean, sigma, mus, bounded),
                              one)
            dkl = torch.where(active, cp.kl_div(mus, mean, sigma),
                              torch.zeros_like(v_st))
            w_clip = torch.minimum(one, rho)
            c_ret = w_clip ** self.acer_trick_pow

            # bootstrap at tend: r[tend] + gamma V(s_tend) unless the
            # window reaches a terminal episode's last state
            lane = torch.arange(B, device=dev)
            idx_end = torch.clamp(nsteps, max=S)
            is_term = rs.slot_term[epl] & (tend == ndata)
            v_end = v_st[lane, idx_end]
            q_boot = r_scaled[lane, idx_end] + torch.where(
                is_term, torch.zeros_like(v_end), gamma * v_end)

            # both recursions, one K1 launch: rows [Q_RET; Q_OPC]
            a_ret, b_ret = window_coeffs(r_scaled, v_st, q_theta, c_ret,
                                         nsteps, q_boot, gamma)
            a_opc, b_opc = window_coeffs(r_scaled, v_st, q_theta, one,
                                         nsteps, q_boot, gamma)
            q = affine_suffix_scan(torch.cat([a_ret, a_opc]).contiguous(),
                                   torch.cat([b_ret, b_opc]).contiguous())
            q_ret_t, q_opc_t = q[:B], q[B:]

            act_s = active[:, :S]
            q_err = torch.where(act_s, q_ret_t - q_theta[:, :S],
                                torch.zeros_like(q_ret_t))
            a_opc = q_opc_t - v_st[:, :S]

            # policy gradient: truncated IS + bias correction
            # (ACER.cpp:78-90)
            def sl(x):
                return x[:, :S]
            prob_pol_mu = torch.exp(cp.logprob_mu(pol_samp, mus, bounded))
            prob_pol_pi = torch.exp(cp.logprob(pol_samp, mean, sigma,
                                               bounded))
            rho_pol = prob_pol_pi / torch.clamp(prob_pol_mu, min=1e-38)
            gain1 = a_opc * torch.clamp(sl(rho), max=5.0)
            gain2 = sl(a_pol_c) * torch.clamp(1.0 - 5.0 / sl(rho_pol),
                                              min=0.0)
            g1m, g1s = cp.pol_grad(sl(acts), sl(mean), sl(sigma), sl(sraw),
                                   gain1, bounded)
            g2m, g2s = cp.pol_grad(sl(pol_samp), sl(mean), sl(sigma),
                                   sl(sraw), gain2, bounded)
            pen_m, pen_s = cp.kl_grad(sl(tgt_mu), sl(mean), sl(sigma),
                                      sl(sraw), torch.ones_like(gain1))
            g_pol = torch.cat([g1m + g2m, g1s + g2s], dim=-1)
            pen = torch.cat([pen_m, pen_s], dim=-1)
            # trust-region projection (trust_region_update,
            # FunctionUtilities.h:238-255, delta == 1)
            dot = torch.sum(g_pol * pen, dim=-1, keepdim=True)
            norm = torch.sum(pen * pen, dim=-1, keepdim=True) + 1.19e-7
            proj = torch.clamp((dot - 1.0) / norm, min=0.0)
            g_pol = (g_pol - proj * pen) * act_s[..., None]

            # output gradients (the window's last position gets none)
            def pad(x):
                return torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
            v_err = q_err * sl(w_clip)
            g_adv = pad(q_err)
            g_aout = torch.cat([
                g_adv[None], torch.zeros_like(g_adv)[None],
                (-g_adv / N_EXPECTATION)[None].expand(
                    (N_EXPECTATION,) + tuple(g_adv.shape))])

        grads = psum_grads_(backprop(
            net, [pout, vout, aout],
            [pad(g_pol), pad(v_err + q_err)[..., None], g_aout[..., None]]),
            mesh)

        # split Adam: the critics at lr x10, both halves reading the one
        # shared step and bias-correction state
        actor_keys = tuple(k for k in net if k not in CRITICS)
        for keys, acfg in ((actor_keys, self.actor_adam),
                           (CRITICS, self.critic_adam)):
            half = AdamState({k: opt_state.m1[k] for k in keys},
                             {k: opt_state.m2[k] for k in keys},
                             opt_state.beta_t_1, opt_state.beta_t_2,
                             opt_state.step)
            adam_update_({k: net[k] for k in keys},
                         {k: grads[k] for k in keys}, half, acfg,
                         1.0 / cfg.batchSize)
        # the shared scalars advance once, by the critics' betas
        new_opt = adam_advance_(opt_state, self.critic_adam)
        # target actor: Polyak from targetDelay, at the new step
        update_target(net["actor"], tgt_actor, cfg.targetDelay, new_opt.step)

        with torch.no_grad():
            # incremental far-count over the written window, from the
            # stored rho gathered above
            was_far = rb.is_far_policy(sl(rho_old), rs.cmax_ret,
                                       rs.cinv_ret) & act_s
            now_far = rb.is_far_policy(sl(rho), rs.cmax_ret,
                                       rs.cinv_ret) & act_s
            rs.far_count.index_add_(
                0, epl, torch.sum(now_far.to(F32) - was_far.to(F32), dim=1))
            # the window write-back; positions past the window's end
            # repeat its last step (index and value)
            wsel = torch.minimum(w[None, :S], nsteps[:, None] - 1)
            wt = twc.gather(1, wsel)
            we = epl[:, None].expand(B, S)
            for dst, new in ((rs.rho_tm, sl(rho)), (rs.kl_tm, sl(dkl)),
                             (rs.delta_tm, q_err), (rs.value_tm, sl(v_st)),
                             (rs.advantage_tm, sl(q_theta - v_st))):
                dst[wt, we] = new.gather(1, wsel)
            rs, frac_off = post_step_processing(rs, cfg, new_opt.step, q_err,
                                                mesh)
            is_far = rb.is_far_policy(sl(rho), rs.cmax_ret, rs.cinv_ret)
            metrics = default_metrics(sl(dkl), sl(rho), is_far, frac_off,
                                      rs.beta, q_err, sl(v_st), mesh)
            metrics.update(grad_stats(grads))
        return params, new_opt, rs, metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def initialize_stats(self, rs: rb.ReplayState, mesh=None):
        """At training start: the exact state/reward statistics only; ACER
        recomputes no returns here (acer.py:386-389)."""
        return rb.update_state_rew_stats(rs, 1.0, b_init=True, mesh=mesh)

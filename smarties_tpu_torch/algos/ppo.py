"""PPO: on-policy clipped-surrogate policy optimization with GAE.

Port of smarties_tpu/algos/ppo.py (reference: Learners/PPO.{h,cpp},
PPO_common.cpp, PPO_train.cpp): a horizon buffer of nHorizon ==
maxTotObsNum fresh transitions, nEpochs == batchSize / obsPerStep passes
of minibatch updates, then the buffer is cleared (PPO.cpp:96-115; the
cycle itself is runtime/trainer.py::_train_on_policy); separate actor and
critic heads (critic lr x3, PPO_common.cpp:70-74) over an optional shared
encoder; GAE returns (the factory default), computed by the replay's
return sweep in its GAE mode.

Reference quirks kept, as in the JAX package (default): the surrogate
"gain" is rho * (ret - V) zeroed by the clip test on the RETURN's sign
(PPO_train.cpp:41-46), and the learned Lagrange penalty coefficient and
the adaptive DKL target are maintained for the metrics although the
reference mixes the KL-penalty gradient with weight 1 against 0, i.e.
pure clip (PPO_train.cpp:52). `ppoStandard: true` swaps in the published
PPO-clip rule: gating on the ADVANTAGE's sign and per-batch advantage
normalisation.

Deviation kept from the JAX package: the reference gates the critic
gradient to far-policy samples only (PPO_train.cpp:69), which leaves the
critic untrained on fresh on-policy data; here the critic trains on all
samples.

Recurrent nets (nnType LSTM/GRU/RNN): as in DPG the recurrence lives in
the shared encoder (synthesised from nnLayerSizes[0] when none is set);
the heads are feed-forward; the features at the sampled step come from
the truncated-BPTT window (algos/base.py).

The gradient is that of one objective, sum(gain.detach() * logp -
0.5 (ret - V)^2), an ASCENT direction as models/optim.py takes it (the
JAX package differentiates the negated loss and flips the sign). In
place: every value written back (rho, dkl, the critic error) and the
counts that move the penalty coefficient and the DKL target come from
the forward made before the Adam step. penal_coef and dkl_target are 0-d
device tensors; a step reads nothing back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from smarties_tpu_torch.algos.base import (Learner, bptt_window,
                                           check_ported, grad_stats,
                                           psum_grads_, returns_mode_of,
                                           seq_outputs, write_back)
from smarties_tpu_torch.algos.dpg import shared_encoder, split_adam_step
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (NetSpec, apply_net, init_carry,
                                           init_params, tree_leaves,
                                           tree_map)
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_init)
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops import discrete_policy as dpol
from smarties_tpu_torch.parallel.mesh import psum_
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters, anneal_rate

F32 = torch.float32


class PPOOptState(NamedTuple):
    adam: AdamState
    penal_coef: torch.Tensor   # 0-d learned Lagrange coefficient (PPO.h:35)
    dkl_target: torch.Tensor   # 0-d adaptive KL target (PPO.h:33)

    @property
    def step(self):
        return self.adam.step


class PPO(Learner):
    on_policy = True

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        check_ported(mdp, cfg)
        self.mdp = mdp
        self.cfg = cfg
        self.discrete = mdp.is_discrete
        nA = mdp.dim_action
        self.n_horizon = cfg.maxTotObsNum
        self.n_epochs = max(1, int(cfg.batchSize / cfg.obsPerStep))
        self.cmax_pol = cfg.clipImpWeight
        self.standard = bool(cfg.ppoStandard)
        self.recurrent, self.enc_spec, feat, head_kind = shared_encoder(
            mdp, cfg)
        self.has_enc = self.enc_spec is not None
        head = dict(n_in=feat, hidden=tuple(cfg.nnLayerSizes),
                    kind=head_kind, act=cfg.nnFunc,
                    out_prefac=cfg.outWeightsPrefac)
        if self.discrete:
            self.n_opts = mdp.max_action_label
            self.actor_spec = NetSpec(n_out=self.n_opts, **head)
        else:
            sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
            self.actor_spec = NetSpec(n_out=nA, n_param_out=nA,
                                      param_init=tuple([sig0] * nA), **head)
        self.critic_spec = NetSpec(n_out=1, **head)
        actor_adam = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                eps_anneal=cfg.epsAnneal)
        # critic lr x3 (PPO_common.cpp:70-74)
        self.part_adam = {None: actor_adam,
                          "critic": actor_adam._replace(
                              eta=3 * cfg.learnrate)}
        self.returns_mode = returns_mode_of(cfg, "GAE")

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        net = {"actor": init_params(gen, self.actor_spec, device),
               "critic": init_params(gen, self.critic_spec, device)}
        if self.has_enc:
            net["enc"] = init_params(gen, self.enc_spec, device)
        dev = tree_leaves(net)[0].device
        opt = PPOOptState(
            adam=adam_init(net),
            penal_coef=torch.tensor(1.0, dtype=F32, device=dev),
            dkl_target=torch.tensor(self.cfg.klDivConstraint, dtype=F32,
                                    device=dev))
        return net, opt

    def init_rnn(self, n_envs: int, device=None):
        """Per-env acting carry: the encoder's recurrent state."""
        return (init_carry(self.enc_spec, (n_envs,), device)
                if self.has_enc else ())

    def _heads(self, net, feat):
        """(policy outputs, V) of the two heads on shared features."""
        pol, _ = apply_net(net["actor"], self.actor_spec, feat)
        v, _ = apply_net(net["critic"], self.critic_spec, feat)
        return pol, v[..., 0]

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """act(params, obs_std, gen, rnn=(), noise=None) -> (action, mu,
        V, zeros, rnn); `noise` replaces the draw from `gen`: clipped
        normals [V, nA] (continuous) or uniforms [V] (discrete)."""
        mdp = self.mdp
        sample = train and self.cfg.explNoise > 0

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=(), noise=None):
            feat = obs_std
            if self.has_enc:
                feat, rnn = apply_net(params["enc"], self.enc_spec, obs_std,
                                      rnn)
            pol, value = self._heads(params, feat)
            zeros = torch.zeros_like(value)
            if self.discrete:
                _, _, probs = dpol.probs_of(pol)
                opt = dpol.select(gen, probs, sample, u=noise)
                return opt[..., None].to(value.dtype), probs, value, zeros, \
                    rnn
            nA = mdp.dim_action
            mean, sigma = pol[..., :nA], cp.sigma_of(pol[..., nA:])
            bounded = mdp.consts(mean)[1]
            if not sample:
                a = cp.eff_mean(mean, bounded)
            elif noise is None:
                a = cp.sample(gen, mean, sigma, bounded)
            else:
                a = cp.sample_with_noise(noise, mean, sigma, bounded)
            return a, cp.mu_vector(mean, sigma, bounded), value, zeros, rnn

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: PPOOptState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None,
                   mesh=None):
        """PPO::Train (PPO_train.cpp:19-71) + updatePenalizationCoef
        (:5-16). In place; returns (params, opt_state, rs, metrics).
        Under a mesh the gradient and the four clip counters are summed
        across ranks; the advantage normalisation and the metrics stay
        per rank, as in the JAX package."""
        cfg = self.cfg
        mb = self.sample_minibatch(rs, gen, sample_override, mesh)
        value_old = mb.value_old       # V recorded at acting time

        if self.recurrent:
            xs, active = bptt_window(rs, mb.ep, mb.t, cfg.nnBPTTseq)
            feat = seq_outputs(params["enc"], self.enc_spec, xs, active)[0]
        elif self.has_enc:
            feat = apply_net(params["enc"], self.enc_spec, mb.s_t)[0]
        else:
            feat = mb.s_t
        pol, v = self._heads(params, feat)
        if self.discrete:
            opt = mb.action[..., 0].long()
            _, _, probs = dpol.probs_of(pol)
            logp = dpol.logprob(opt, probs)
        else:
            nA = self.mdp.dim_action
            mean, sigma = pol[..., :nA], cp.sigma_of(pol[..., nA:])
            bounded = self.mdp.consts(mean)[1]
            logp = cp.logprob(mb.action, mean, sigma, bounded)

        with torch.no_grad():
            if self.discrete:
                # 1e-38 is below f32's smallest normal: a stored
                # probability of 0 gives log(1e-38) = -87.5 here, where a
                # backend that flushes subnormals (XLA on the CPU) gives
                # -inf; no behaviour policy samples such an option
                logmu = torch.log(torch.clamp(
                    torch.gather(mb.mu, -1, opt[..., None])[..., 0],
                    min=1e-38))
                rho = torch.exp(logp - logmu)
                dkl = dpol.kl_mu_pi(mb.mu, probs)
            else:
                rho = cp.imp_weight(mb.action, mean, sigma, mb.mu, bounded)
                dkl = cp.kl_div(mb.mu, mean, sigma)
            adv = mb.qret - value_old
            zero = torch.zeros_like(rho)
            if self.standard:
                # the gradient of min(rho A, clip(rho, 1-eps, 1+eps) A) is
                # A rho dlogpi, zeroed when (A > 0 and rho > 1+eps) or
                # (A < 0 and rho < 1-eps); advantages normalised per
                # batch over the valid rows
                w = mb.valid.to(F32)
                n = torch.clamp(torch.sum(w), min=1.0)
                a_mu = torch.sum(adv * w) / n
                a_sd = torch.sqrt(torch.clamp(
                    torch.sum(w * (adv - a_mu) ** 2) / n, min=1e-8))
                adv = (adv - a_mu) / a_sd
                sign = adv
            else:
                # the reference's clip-on-RETURN gating (:41-46)
                sign = mb.qret
            gain = torch.where(
                (sign > 0) & (rho > 1 + self.cmax_pol), zero,
                torch.where((sign < 0) & (rho < 1 - self.cmax_pol), zero,
                            rho * adv))
            verr = (mb.qret - v).detach()
            is_off = (rho > 1 + self.cmax_pol) | (rho < 1 - self.cmax_pol)

            # Lagrange coefficient + adaptive DKL target, batch-aggregated
            # (updatePenalizationCoef PPO_train.cpp:5-16, updateDKL_target
            # PPO_common.cpp:8-16)
            tgt, penal = opt_state.dkl_target, opt_state.penal_coef
            counts = torch.stack([
                torch.sum((dkl < tgt / 1.5).to(F32)),
                torch.sum((dkl > 1.5 * tgt).to(F32)),
                torch.sum((is_off & (tgt > dkl)).to(F32)),
                torch.sum(((~is_off) & (tgt < dkl)).to(F32))])
            n_rows = rho.shape[0]
            if mesh is not None:
                psum_(mesh, counts)
                n_rows *= mesh.size
            n_lo, n_hi, n_shrink, n_grow = counts.unbind()
            delta = n_hi * penal - n_lo * penal / 2
            penal = torch.clamp(
                penal + 1e-4 * delta / max(float(n_rows), 1.0),
                min=1.19e-7)
            tgt = tgt * torch.pow(0.9995, n_shrink) \
                * torch.pow(1.0001, n_grow)

        # policyGradient(act, gain) is gain * dlogpi: the surrogate is
        # gain.detach() * logp; the critic trains on every sample
        err = mb.qret - v
        objective = torch.sum(gain * logp - 0.5 * err * err)
        for p in tree_leaves(params):
            p.grad = None
        objective.backward()
        grads = psum_grads_(tree_map(lambda p: p.grad, params), mesh)
        adam = split_adam_step(params, grads, opt_state.adam, self.part_adam,
                               1.0 / cfg.batchSize)
        opt_state = PPOOptState(adam=adam, penal_coef=penal, dkl_target=tgt)

        with torch.no_grad():
            rs = write_back(rs, mb, rho, dkl, verr, value_old,
                            torch.zeros_like(verr))
            metrics = {
                "avg_dkl": torch.mean(dkl), "avg_rho": torch.mean(rho),
                "frac_far_batch": torch.mean(is_off.to(F32)),
                "frac_far_data": torch.zeros_like(penal),
                "beta": penal, "rmse": torch.sqrt(torch.mean(verr * verr)),
                "avg_v": torch.mean(value_old),
            }
            metrics.update(grad_stats(grads))
        return params, opt_state, rs, metrics

    # ------------------------------------------------------------------
    @torch.no_grad()
    def refresh(self, rs: rb.ReplayState, n_grad_steps: float, mesh=None):
        """Once per horizon, after its epochs: the state and reward
        statistics move at min(1, annealed learning rate)
        (updateRewardsStats, PPO.cpp:100-104). No return sweep: the data
        is cleared next."""
        lr = anneal_rate(self.cfg.learnrate, n_grad_steps,
                         self.cfg.epsAnneal)
        return rb.update_state_rew_stats(rs, min(1.0, lr), mesh=mesh)

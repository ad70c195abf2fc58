"""DPG/DDPG: deterministic policy gradient with ReF-ER.

Port of smarties_tpu/algos/dpg.py (reference:
Learners/DPG.{h,cpp}): an optional shared encoder (encoderLayerSizes,
its output through nnFunc), an actor (mean + param-stdev exploration)
and a Q-critic taking the action as an extra input; target nets on every
part; the critic steps with 10x the learning rate and L2 1e-4
(DPG.cpp:201-203); Retrace targets or 1-step TD with the target nets.

The gradient is that of one objective whose parameter gradient is the
reference's hand-wired output gradients: the critic ascends
(target - Q(s, a)), zeroed far-policy; the actor mean takes
beta dQ/da at a = pol(s) + (1 - beta)(-dKL); the stdev is pulled toward
explNoise. dQ/da comes from a critic evaluated on DETACHED weights and
features, so it reaches only the actor. As in the JAX package
(DEVIATIONS #3) the ONLINE critic is used, not the target one, and the
1-step target reads r_{t+1}.

With a recurrent nnType the recurrence lives in the shared encoder (one
is synthesised from nnLayerSizes[0] when none is set: every encoder size
is then a recurrent hidden layer, with a same-size projection out); the
actor and critic heads stay feed-forward. Features at t and t+1 come
from the truncated-BPTT window (algos/base.py); the encoder's carry
follows the Ornstein-Uhlenbeck state in the acting carry.

In place: the Adam step updates the leaves, so every value the step
writes back (Q(s, a), V(s) = Q(s, pol(s)), the bootstrap) is computed
from the pre-step weights, before the step, as the JAX package computes
it from its unchanged input params.
"""
from __future__ import annotations

import torch

from smarties_tpu_torch.algos.base import (Learner, bptt_window,
                                           check_ported, explore, ou_acting,
                                           psum_grads_, returns_mode_of,
                                           seq_outputs, step_tail_,
                                           target_copy)
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import (NetSpec, apply_net, init_carry,
                                           init_params, join, tree_leaves,
                                           tree_map)
from smarties_tpu_torch.models.optim import (AdamConfig, AdamState,
                                             adam_advance_, adam_init,
                                             adam_update_, update_target)
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters


def split_adam_step(net, grads, opt: AdamState, part_cfgs, grad_factor):
    """One Adam step over the top-level parts of `net`, each part with
    its own AdamConfig (part_cfgs maps a part name to it, None to the
    config of every other part). All parts share one beta_t / step, which
    advances once."""
    groups = {}
    for k in net:
        groups.setdefault(k if k in part_cfgs else None, []).append(k)
    for name, keys in groups.items():
        sub = lambda tree: {k: tree[k] for k in keys}
        # every part reads the same old scalars; the moments move in place
        adam_update_(sub(net), sub(grads),
                     AdamState(sub(opt.m1), sub(opt.m2), opt.beta_t_1,
                               opt.beta_t_2, opt.step),
                     part_cfgs[name], grad_factor)
    # then the shared scalars advance once, by the last part's betas
    return adam_advance_(opt, part_cfgs[name])


def shared_encoder(mdp, cfg):
    """The shared encoder of DPG and PPO -> (recurrent?, its NetSpec or
    None, the feature width the heads read, the heads' kind). Its last
    size is its output, through nnFunc. A recurrent nnType puts the
    recurrence in the encoder, synthesised from nnLayerSizes[0] when none
    is set: every size is then a recurrent hidden layer, with a same-size
    projection out, and the heads are feed-forward."""
    recurrent = cfg.nnType in ("LSTM", "GRU", "RNN")
    sizes = tuple(s for s in cfg.encoderLayerSizes if s > 0)
    if recurrent and not sizes:
        sizes = (cfg.nnLayerSizes[0],)
    head_kind = "FFNN" if recurrent else cfg.nnType
    if not sizes:
        return recurrent, None, mdp.dim_net_input, head_kind
    spec = NetSpec(n_in=mdp.dim_net_input,
                   hidden=sizes if recurrent else sizes[:-1],
                   n_out=sizes[-1], kind=cfg.nnType, act=cfg.nnFunc,
                   out_prefac=1.0, out_act=cfg.nnFunc)
    return recurrent, spec, sizes[-1], head_kind


class DPG(Learner):

    def __init__(self, mdp: MDPSpec, cfg: HyperParameters):
        if mdp.is_discrete:
            raise ValueError("DPG requires continuous actions")
        check_ported(mdp, cfg)
        self.mdp = mdp
        self.cfg = cfg
        nA = mdp.dim_action
        self.recurrent, self.enc_spec, feat, head_kind = shared_encoder(
            mdp, cfg)
        self.has_enc = self.enc_spec is not None
        sig0 = float(cp.initial_sigma_raw(cfg.explNoise))
        self.actor_spec = NetSpec(
            n_in=feat, hidden=tuple(cfg.nnLayerSizes), n_out=nA,
            kind=head_kind, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac,
            n_param_out=nA, param_init=tuple([sig0] * nA))
        self.critic_spec = NetSpec(
            n_in=feat + nA, hidden=tuple(cfg.nnLayerSizes), n_out=1,
            kind=head_kind, act=cfg.nnFunc,
            out_prefac=cfg.outWeightsPrefac)
        actor_adam = AdamConfig(eta=cfg.learnrate, lambda_=cfg.nnLambda,
                                eps_anneal=cfg.epsAnneal)
        # the critic wants lr x10 and L2 1e-4 (DPG.cpp:201-203)
        self.part_adam = {None: actor_adam, "critic": AdamConfig(
            eta=10 * cfg.learnrate, lambda_=1e-4, eps_anneal=cfg.epsAnneal)}
        self.returns_mode = returns_mode_of(cfg, "none")

    # ------------------------------------------------------------------
    def init(self, gen: torch.Generator, device=None):
        net = {"actor": init_params(gen, self.actor_spec, device),
               "critic": init_params(gen, self.critic_spec, device)}
        if self.has_enc:
            net["enc"] = init_params(gen, self.enc_spec, device)
        return {"net": net, "tgt": target_copy(net)}, adam_init(net)

    def init_rnn(self, n_envs: int, device=None):
        """Per-env carry: (Ornstein-Uhlenbeck noise state [n_envs, nA],
        *the encoder's recurrent carry)."""
        ou = torch.zeros((n_envs, self.mdp.dim_action), dtype=torch.float32,
                         device=device)
        enc = (init_carry(self.enc_spec, (n_envs,), device)
               if self.has_enc else ())
        return (ou,) + enc

    # ------------------------------------------------------------------
    def _feat(self, net, x):
        if self.has_enc:
            return apply_net(net["enc"], self.enc_spec, x)[0]
        return x

    def _actor(self, net, feat):
        out, _ = apply_net(net["actor"], self.actor_spec, feat)
        nA = self.mdp.dim_action
        return out[..., :nA], out[..., nA:]

    def _critic(self, net, feat, action):
        q, _ = apply_net(net["critic"], self.critic_spec,
                         join(feat, action))
        return q[..., 0]

    # ------------------------------------------------------------------
    def make_act_fn(self, train: bool = True):
        """act(params, obs_std, gen, rnn=(ou, *encoder carry), noise=None);
        `noise` is the clipped-normal draw [V, nA] that replaces one from
        `gen`."""
        mdp = self.mdp
        sample, use_ou = ou_acting(self.cfg, train)

        @torch.no_grad()
        def act(params, obs_std, gen, rnn=(), noise=None):
            net = params["net"]
            if self.has_enc:
                feat, enc_carry = apply_net(net["enc"], self.enc_spec,
                                            obs_std, rnn[1:])
            else:
                feat, enc_carry = obs_std, ()
            mean, sraw = self._actor(net, feat)
            ou = rnn[0] if rnn else torch.zeros_like(mean)
            sigma = cp.sigma_of(sraw)
            bounded = mdp.consts(mean)[1]
            if sample:
                a, ou = explore(gen, mean, sigma, bounded, ou, use_ou, noise)
            else:
                a = cp.eff_mean(mean, bounded)
            mu = cp.mu_vector(mean, sigma, bounded)
            # appendValues(V = Q(s, pol(s)), Q = Q(s, a)) (DPG.cpp:100-105)
            v = self._critic(net, feat, mean)
            q = self._critic(net, feat, a)
            return a, mu, v, q - v, (ou,) + enc_carry

        return act

    # ------------------------------------------------------------------
    def train_step(self, params, opt_state: AdamState, rs: rb.ReplayState,
                   gen: torch.Generator | None = None, sample_override=None,
                   mesh=None):
        """DPG::Train (DPG.cpp:12-80). In place; returns (params,
        opt_state, rs, metrics)."""
        cfg = self.cfg
        mb = self.sample_minibatch(rs, gen, sample_override, mesh)
        net, tgt = params["net"], params["tgt"]

        # the objective's forward, with grad; a recurrent encoder runs the
        # BPTT window and gives the features at t+1 (without grad) too
        if self.recurrent:
            window = bptt_window(rs, mb.ep, mb.t, cfg.nnBPTTseq)
            feat, feat1_on = seq_outputs(net["enc"], self.enc_spec, *window)
        else:
            feat = self._feat(net, mb.s_t)
        q_taken = self._critic(net, feat, mb.action)
        m, sr = self._actor(net, feat)
        # dQ/da through the critic's action input only
        q_pol = self._critic(tree_map(lambda x: x.detach(), net),
                             feat.detach(), m)
        with torch.no_grad():
            feat_ng = feat.detach()
            mean, sraw = m.detach(), sr.detach()
            sigma = cp.sigma_of(sraw)
            bounded = self.mdp.consts(mean)[1]
            rho = cp.imp_weight(mb.action, mean, sigma, mb.mu, bounded)
            dkl = cp.kl_div(mb.mu, mean, sigma)
            is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
            boot_net = net if self.returns_mode != "none" else tgt
            if not self.recurrent:
                feat1 = self._feat(boot_net, mb.s_t1)
            elif boot_net is net:
                feat1 = feat1_on
            else:
                feat1 = seq_outputs(tgt["enc"], self.enc_spec, *window)[1]
            v_next = self._critic(boot_net, feat1,
                                  self._actor(boot_net, feat1)[0])
            if self.returns_mode != "none":
                target = mb.qret
            else:
                target = mb.reward_next + torch.where(
                    mb.terminal_next | is_far, torch.zeros_like(v_next),
                    cfg.gamma * v_next)
            beta = rs.beta
            q_val = q_taken.detach()
            v_val = self._critic(net, feat_ng, mean)
            zero = torch.zeros_like(rho)
            q_coef = torch.where(is_far, zero, target - q_val)
            dpg_gate = torch.where(is_far, zero, beta * torch.ones_like(rho))

        s = cp.sigma_of(sr)
        kl = cp.kl_div(mb.mu, m, s)
        # d/dsr of -(sigma - expl)^2 / 4 is sp'(sr)(expl - sigma) / 2: the
        # reference's fixExplorationGrad
        fix = -torch.sum(torch.square(s - cfg.explNoise), dim=-1) / 4
        objective = torch.sum(q_coef * q_taken + dpg_gate * q_pol
                              - (1 - beta) * kl + fix)
        for p in tree_leaves(net):
            p.grad = None
        objective.backward()
        grads = psum_grads_(tree_map(lambda p: p.grad, net), mesh)
        opt_state = split_adam_step(net, grads, opt_state, self.part_adam,
                                    1.0 / cfg.batchSize)
        update_target(net, tgt, cfg.targetDelay, opt_state.step)

        with torch.no_grad():
            err = target - q_val
            rs, metrics = step_tail_(rs, mb, cfg, opt_state.step, grads, rho,
                                     dkl, err, v_val, q_val - v_val, v_next,
                                     is_far, mesh)
        return params, opt_state, rs, metrics

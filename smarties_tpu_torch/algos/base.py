"""Common learner machinery: minibatch gather, write-backs, bookkeeping.

Port of smarties_tpu/algos/base.py (reference: Learners/Learner*.cpp,
ReplayMemory/MiniBatch.h). The gathers index the replay's time-major
fields at [t, ep]; the write-backs are in-place index writes with no
host synchronisation. `Learner` holds what every ported learner shares:
the minibatch draw and the two return sweeps. The target copy serves
DQN, NAF and DPG; the OU exploration serves NAF and DPG.

Recurrent nets train by truncated BPTT over a window that ends at the
sampled step (the reference builds per-sample windows [t - nnBPTTseq,
t + 2) with a zeroed recurrent context at the window start for every
learner, MemoryBuffer.cpp:393-402, Network.h:155-193): `bptt_window`
gathers the window, `seq_outputs` runs the net over it, a Python loop of
nnBPTTseq + 1 net steps under autograd, and `seq_forward_vjp` pairs the
outputs with the pullback of an output-space gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from smarties_tpu_torch.models.net import (apply_net, init_carry,
                                           tree_leaves, tree_map)
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import anneal_rate

F32 = torch.float32


def bptt_window(rs: rb.ReplayState, ep, t, W: int):
    """Standardized state inputs over the window [t-W+1, t+1] ->
    (xs [B, W+1, dimS], active [B, W+1]). The last two positions are the
    sampled step t and its successor t+1 (the stored row, the terminal
    state's when t+1 is the slot's length); positions before the episode
    start are inactive and zeroed (a slot holds exactly one episode, so
    t < 0 is the only boundary)."""
    offs = torch.arange(-W + 1, 2, device=t.device)
    tw = t.long()[:, None] + offs[None, :]               # [B, W+1]
    active = tw >= 0
    twc = torch.clamp(tw, 0, rs.max_len)
    xs = (rs.states_tm[twc, ep.long()[:, None]]
          - rs.state_mean) * rs.state_scale              # [B, W+1, dimS]
    return torch.where(active[..., None], xs, torch.zeros_like(xs)), active


def seq_outputs(params, spec, xs, active):
    """Run a recurrent net over a [B, T] window from a zero carry,
    holding the carry where `active` is False -> (out_t, out_t1), the
    outputs at the last two window positions (the sampled step and its
    successor). out_t is differentiable; the step to t+1 runs without
    grad, since no learner differentiates it (the JAX package's learners
    stop its gradient or give it a zero cotangent)."""
    carry = init_carry(spec, (xs.shape[0],), xs.device)
    steps = list(zip(xs.unbind(1), active.unbind(1)))
    y = None
    for x, m in steps[:-1]:
        y, new = apply_net(params, spec, x, carry)
        carry = tree_map(lambda a, b: torch.where(m[:, None], a, b),
                         new, carry)
    with torch.no_grad():
        y1, _ = apply_net(params, spec, steps[-1][0], carry)
    return y, y1


def seq_forward_vjp(params, spec, xs, active):
    """seq_outputs with its pullback: (out_t.detach(), out_t1, pullback),
    where pullback(g) backpropagates an output-space gradient at the
    sampled step t through the whole window (reverse BPTT,
    Network.h:155-193) into the parameter-gradient tree."""
    out_t, out_t1 = seq_outputs(params, spec, xs, active)
    return out_t.detach(), out_t1, lambda g: backprop(params, out_t, g)


class MiniBatch(NamedTuple):
    """Gathered view of B sampled transitions (MiniBatch.h:60-123): the
    fields the learners read."""
    ep: torch.Tensor             # [B] episode slot
    t: torch.Tensor              # [B] time index
    s_t: torch.Tensor            # [B, dimS] standardized state
    s_t1: torch.Tensor           # [B, dimS] standardized next state
    action: torch.Tensor         # [B, dimA]
    mu: torch.Tensor             # [B, dimPol]
    qret: torch.Tensor           # [B] stored return estimate
    reward_next: torch.Tensor    # [B] scaled reward r_{t+1}
    terminal_next: torch.Tensor  # [B] t+1 is a true terminal state
    truncated_next: torch.Tensor  # [B] t+1 == T is a truncation point
    # PER importance weight (1 for uniform). Carried and never applied to
    # a gradient, as in the reference (Approximator.h:196 is commented out)
    per_w: torch.Tensor          # [B]
    # sample points at a stored transition (False only for an empty
    # replay): such rows give no gradient and no write-backs
    valid: torch.Tensor          # [B] bool
    rho_old: torch.Tensor        # [B] stored rho (far-count delta)
    value_old: torch.Tensor      # [B] stored V (PPO's acting-time baseline)


def presample_uniform(gen: torch.Generator, rs: rb.ReplayState, batch: int,
                      n: int):
    """Uniform sample indices for a whole train chunk at once -> (ep [n, B],
    t [n, B]). The sampling cache only changes at commit/refresh, never
    inside a train chunk, so drawing up front equals drawing per step."""
    return rb.sample_uniform_from_flat(rs, rb.draw_flat(gen, rs, (n, batch)))


def stacked_states(rs: rb.ReplayState, ep, t, n_appended: int):
    """Standardized net input with appended past observations
    (Episode::standardizedState, Episode.h:171-183): frames ordered
    [obs_t, obs_{t-1}, ...], clamped at the episode start ->
    [B, (k+1) dimS]. A uint8 replay is promoted to f32 here."""
    epl, tl = ep.long(), t.long()
    if n_appended == 0:
        return (rs.states_tm[tl, epl] - rs.state_mean) * rs.state_scale
    offs = torch.arange(n_appended + 1, device=tl.device)
    tj = torch.clamp(tl[:, None] - offs[None, :], min=0)     # [B, k+1]
    frames = (rs.states_tm[tj, epl[:, None]]
              - rs.state_mean) * rs.state_scale              # [B, k+1, dimS]
    return frames.reshape(frames.shape[0], -1)


def gather_minibatch(rs: rb.ReplayState, ep, t,
                     n_appended: int = 0) -> MiniBatch:
    """Gather the sampled transitions (the JAX package's flat path; its
    NHWC-direct gather is not ported). With appended frames the stacks of
    t and t+1 share k of their k+1 frames: ONE gather of the union window
    [t+1, t, ..., t-k], clamped at 0, standardized once, then sliced; the
    values are those of two stacked_states calls."""
    epl, tl = ep.long(), t.long()
    t1 = torch.clamp(tl + 1, max=rs.max_len)
    B = ep.shape[0]
    if n_appended:
        offs = torch.arange(-1, n_appended + 1, device=tl.device)
        tj = torch.clamp(tl[:, None] - offs[None, :], min=0,
                         max=rs.max_len)                     # [B, k+2]
        frames = (rs.states_tm[tj, epl[:, None]]
                  - rs.state_mean) * rs.state_scale          # [B, k+2, dimS]
        s_cat = torch.cat([frames[:, 1:].reshape(B, -1),
                           frames[:, :-1].reshape(B, -1)])
    else:
        s_cat = (rs.states_tm[torch.cat([tl, t1]), torch.cat([epl, epl])]
                 - rs.state_mean) * rs.state_scale
    length = rs.slot_len[epl]
    is_last = (t + 1) == length
    valid = (rs.slot_id[epl] >= 0) & (t < length)
    terminal = rs.slot_term[epl]
    r_next = (rs.rewards_tm[t1, epl] - rs.rew_mean) * rs.rew_scale
    return MiniBatch(ep=ep, t=t, s_t=s_cat[:B], s_t1=s_cat[B:],
                     action=rs.actions_tm[tl, epl], mu=rs.mus_tm[tl, epl],
                     qret=rs.qret_tm[tl, epl], reward_next=r_next,
                     terminal_next=is_last & terminal,
                     truncated_next=is_last & (~terminal),
                     per_w=torch.ones(ep.shape, dtype=F32, device=ep.device),
                     valid=valid, rho_old=rs.rho_tm[tl, epl],
                     value_old=rs.value_tm[tl, epl])


def check_ported(mdp, cfg, frames: bool = False):
    """Refuse the settings that no code path serves. `frames`: the learner
    gathers appended past observations (RACER family and DQN, as in the
    JAX package; its other learners size their net for the stacked input
    and gather single frames, which fails there with a shape error). A
    recurrent net with appended observations fails there the same way:
    bptt_window gathers single frames."""
    if mdp.n_appended_obs and not frames:
        raise ValueError(
            f"learner {cfg.learner!r} gathers no appended observations "
            f"(n_appended_obs = {mdp.n_appended_obs}): only the RACER "
            f"family and DQN stack frames")
    if mdp.n_appended_obs and cfg.nnType != "FFNN":
        raise ValueError(
            f"nnType {cfg.nnType!r} with appended observations: the BPTT "
            f"window gathers single frames")


def returns_mode_of(cfg, default: str) -> str:
    """The return estimator: cfg.returnsEstimator, with "default" meaning
    the learner's factory default ("retrace" for RACER/MixedPG, "none"
    for DQN/NAF/DPG)."""
    mode = cfg.returnsEstimator
    return default if mode == "default" else mode


class Learner:
    """What every ported learner shares: the minibatch draw and the
    every-1000-steps and initial return sweeps. Subclasses set cfg and
    returns_mode. An `on_policy` learner (PPO) is driven by the trainer's
    horizon cycle instead of the obsPerStep pacing."""
    on_policy = False
    # appended past observations in the minibatch gather: set from the MDP
    # by the learners that stack frames (RACER family, DQN)
    n_appended = 0

    def sample_minibatch(self, rs: rb.ReplayState, gen, sample_override):
        """Pinned (ep, t) indices (the trainer's presampled chunk, the
        parity tests), or a draw of batchSize from `gen` by the sampler
        cfg.dataSamplingAlgo names."""
        if sample_override is not None:
            ep, t = sample_override
        else:
            ep, t = rb.sample(gen, rs, self.cfg.batchSize,
                              self.cfg.dataSamplingAlgo)
        return gather_minibatch(rs, ep, t, n_appended=self.n_appended)

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

    @torch.no_grad()
    def initialize_stats(self, rs: rb.ReplayState):
        """At training start: exact state/reward stats from the gathered
        data, then all return estimators (Learner::initializeLearner,
        Learner.cpp:47-72)."""
        rs = rb.update_state_rew_stats(rs, 1.0, b_init=True)
        return rb.recompute_returns(rs, self.cfg.gamma, self.cfg.lambda_,
                                    self.returns_mode)


def target_copy(net):
    """Target weights: a copy of `net` that does not require grad (an
    alias would make the Polyak update a no-op)."""
    return tree_map(lambda x: x.detach().clone(), net)


def ou_acting(cfg, train: bool):
    """The exploration of DPG and NAF: (sample, use_ou). OU noise decays
    the state by 0.85 when clipImpWeight <= 0 (DPG.h:20, NAF.h:25)."""
    sample = train and cfg.explNoise > 0
    return sample, sample and cfg.clipImpWeight <= 0


def explore(gen, mean, sigma, bounded, ou_prev, use_ou, noise=None):
    """A training action of DPG/NAF -> (action, new OU state): OU noise
    or a plain Gaussian draw, from `gen` or the given clipped normals."""
    if noise is None:
        noise = cp.clipped_normal(gen, tuple(mean.shape), mean)
    if use_ou:
        return cp.sample_ou(noise, ou_prev, mean, sigma, bounded)
    return cp.sample_with_noise(noise, mean, sigma, bounded), ou_prev


def backprop(params, outputs, cotangents):
    """Pull output-space ascent gradients back through the net:
    `out.backward(gradient=g)` for each (out, g) pair, into the leaves of
    `params`, which must all take part. Returns the gradient tree."""
    for p in tree_leaves(params):
        p.grad = None
    torch.autograd.backward(outputs, grad_tensors=cotangents)
    return tree_map(lambda p: p.grad, params)


def write_back(rs: rb.ReplayState, mb: MiniBatch, rho, dkl, delta, value,
               advantage) -> rb.ReplayState:
    """MiniBatch::setMseDklImpw + setValues (MiniBatch.h:161-188) and the
    incremental far-policy count (Episode::updateCumulative_atomic,
    Episode.h:112-129). In place.

    The JAX package drops invalid rows at a trash index (mode="drop");
    here an invalid row writes back the value it read, so no index needs
    dropping."""
    tl, epl = mb.t.long(), mb.ep.long()
    valid = mb.valid
    was_far = rb.is_far_policy(mb.rho_old, rs.cmax_ret, rs.cinv_ret)
    is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
    delta_far = torch.where(valid, is_far.to(F32) - was_far.to(F32),
                            torch.zeros_like(rho))
    for dst, new in ((rs.rho_tm, rho), (rs.kl_tm, dkl),
                     (rs.delta_tm, delta), (rs.value_tm, value),
                     (rs.advantage_tm, advantage)):
        dst[tl, epl] = torch.where(valid, new, dst[tl, epl])
    rs.far_count.index_add_(0, epl, delta_far)
    return rs


def write_back_with_next(rs: rb.ReplayState, mb: MiniBatch, rho, dkl,
                         delta, value, advantage,
                         v_next) -> rb.ReplayState:
    """write_back plus the V(s_T) refresh of sampled pre-truncation
    steps (MB.setValues(t+1, vNext), RACER_train.cpp:23-27) into the
    v_trunc side-channel. In place.

    Rows of one slot may disagree on whether they are truncated, so the
    v_trunc scatter goes through an [E+1] scratch copy whose last entry
    takes the non-truncated rows."""
    rs = write_back(rs, mb, rho, dkl, delta, value, advantage)
    E = rs.n_slots
    epl = mb.ep.long()
    scratch = torch.cat([rs.v_trunc, rs.v_trunc[:1]])
    scratch[torch.where(mb.truncated_next, epl, torch.full_like(epl, E))] = \
        v_next
    rs.v_trunc.copy_(scratch[:E])
    return rs


def post_step_processing(rs: rb.ReplayState, cfg, opt_step, delta_q):
    """Per-grad-step memory processing (Learner::processMemoryBuffer,
    Learner.cpp:74-100): anneal CmaxRet, ReF-ER beta fixed point,
    maxAbsError EMA. Returns (rs, frac_off_policy)."""
    n_step = opt_step.to(F32)
    rs = rb.update_cmax(rs, n_step, cfg.clipImpWeight, cfg.epsAnneal)
    rs, frac_off = rb.update_beta_alpha(rs, cfg.batchSize, cfg.maxTotObsNum,
                                        cfg.penalTol)
    n_stored = rs.n_stored_steps().to(F32)
    batch_max_err = torch.max(torch.abs(delta_q))
    learn_r = 0.1 * cfg.batchSize / torch.clamp(
        n_stored, min=float(cfg.maxTotObsNum))
    rs.max_abs_error = rs.max_abs_error + learn_r * (batch_max_err
                                                     - rs.max_abs_error)
    return rs, frac_off


def grad_stats(grads):
    """Gradient-moment tracking (StatsTracker analog): global norm and
    largest absolute leaf value."""
    leaves = tree_leaves(grads)
    sq = sum(torch.sum(x * x) for x in leaves)
    mx = torch.max(torch.stack([torch.max(torch.abs(x)) for x in leaves]))
    return {"grad_norm": torch.sqrt(sq), "grad_max": mx}


def default_metrics(dkl, rho, is_far, frac_off, beta, delta_q, v_val):
    return {
        "avg_dkl": torch.mean(dkl),
        "avg_rho": torch.mean(rho),
        "frac_far_batch": torch.mean(is_far.to(F32)),
        "frac_far_data": frac_off,
        "beta": beta,
        "rmse": torch.sqrt(torch.mean(delta_q * delta_q)),
        "avg_v": torch.mean(v_val),
    }

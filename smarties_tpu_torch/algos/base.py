"""Common learner machinery: minibatch gather, write-backs, bookkeeping.

Port of the parts of smarties_tpu/algos/base.py that V-RACER calls
(reference: Learners/Learner*.cpp, ReplayMemory/MiniBatch.h). The
gathers index the replay's time-major fields at [t, ep]; the write-backs
are in-place index writes with no host synchronisation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from smarties_tpu_torch.models.net import tree_leaves
from smarties_tpu_torch.replay import buffer as rb

F32 = torch.float32


class MiniBatch(NamedTuple):
    """Gathered view of B sampled transitions (MiniBatch.h:60-123): the
    fields V-RACER reads. The JAX package's reward_next, terminal_next,
    per_w and value_old arrive with the learners that read them."""
    ep: torch.Tensor             # [B] episode slot
    t: torch.Tensor              # [B] time index
    s_t: torch.Tensor            # [B, dimS] standardized state
    s_t1: torch.Tensor           # [B, dimS] standardized next state
    action: torch.Tensor         # [B, dimA]
    mu: torch.Tensor             # [B, dimPol]
    qret: torch.Tensor           # [B] stored return estimate
    truncated_next: torch.Tensor  # [B] t+1 == T is a truncation point
    # sample points at a stored transition (False only for an empty
    # replay): such rows give no gradient and no write-backs
    valid: torch.Tensor          # [B] bool
    rho_old: torch.Tensor        # [B] stored rho (far-count delta)


def presample_uniform(gen: torch.Generator, rs: rb.ReplayState, batch: int,
                      n: int):
    """Uniform sample indices for a whole train chunk at once -> (ep [n, B],
    t [n, B]). The sampling cache only changes at commit/refresh, never
    inside a train chunk, so drawing up front equals drawing per step."""
    return rb.sample_uniform_from_flat(rs, rb.draw_flat(gen, rs, (n, batch)))


def gather_minibatch(rs: rb.ReplayState, ep, t) -> MiniBatch:
    """Gather the sampled transitions (the JAX package's non-appended,
    non-NHWC path)."""
    epl, tl = ep.long(), t.long()
    t1 = torch.clamp(tl + 1, max=rs.max_len)
    s_cat = (rs.states_tm[torch.cat([tl, t1]), torch.cat([epl, epl])]
             - rs.state_mean) * rs.state_scale
    B = ep.shape[0]
    length = rs.slot_len[epl]
    is_last = (t + 1) == length
    valid = (rs.slot_id[epl] >= 0) & (t < length)
    return MiniBatch(ep=ep, t=t, s_t=s_cat[:B], s_t1=s_cat[B:],
                     action=rs.actions_tm[tl, epl], mu=rs.mus_tm[tl, epl],
                     qret=rs.qret_tm[tl, epl],
                     truncated_next=is_last & (~rs.slot_term[epl]),
                     valid=valid, rho_old=rs.rho_tm[tl, epl])


def write_back_with_next(rs: rb.ReplayState, mb: MiniBatch, rho, dkl,
                         delta, value, advantage,
                         v_next) -> rb.ReplayState:
    """MiniBatch::setMseDklImpw + setValues (MiniBatch.h:161-188), the
    incremental far-policy count (Episode::updateCumulative_atomic,
    Episode.h:112-129) and the V(s_T) refresh of sampled pre-truncation
    steps (MB.setValues(t+1, vNext), RACER_train.cpp:23-27) into the
    v_trunc side-channel. In place.

    The JAX package drops invalid rows at a trash index (mode="drop");
    here an invalid row writes back the value it read, so no index needs
    dropping. For v_trunc, rows of one slot may disagree on whether they
    are truncated, so the scatter goes through an [E+1] scratch copy
    whose last entry takes the non-truncated rows."""
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
    E = rs.n_slots
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

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
gathers the window, `seq_outputs` runs the net over it, and
`seq_forward_vjp` pairs the outputs with the pullback of an output-space
gradient. On the card an LSTM that ops/lstm_window_kernel.py `takes` runs
the window in its two launches (`window_outputs`); every other net, and
every net on the CPU, runs a Python loop of nnBPTTseq + 1 net steps under
autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from smarties_tpu_torch.models.net import (apply_net, apply_out,
                                           init_carry, tree_leaves,
                                           tree_map)
from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops import lstm_window_kernel, step_tail_kernel
from smarties_tpu_torch.ops.value_scale import scale_net2v
from smarties_tpu_torch.parallel.mesh import pmax_, pmean, psum_tree_
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
    stop its gradient or give it a zero cotangent). CUDA tensors of an
    LSTM that the window kernel takes go to `window_outputs`; the rest
    run `chain_outputs`."""
    if xs.is_cuda and lstm_window_kernel.takes(spec):
        return window_outputs(params, spec, xs, active)
    return chain_outputs(params, spec, xs, active)


def chain_outputs(params, spec, xs, active):
    """seq_outputs as a Python loop of apply_net under autograd: the
    window's W + 1 net steps, each with its output layer."""
    carry = init_carry(spec, (xs.shape[0],), xs.device, xs.dtype)
    steps = list(zip(xs.unbind(1), active.unbind(1)))
    y = None
    for x, m in steps[:-1]:
        y, new = apply_net(params, spec, x, carry)
        carry = tree_map(lambda a, b: torch.where(m[:, None], a, b),
                         new, carry)
    with torch.no_grad():
        y1, _ = apply_net(params, spec, steps[-1][0], carry)
    return y, y1


def window_outputs(params, spec, xs, active):
    """seq_outputs of an LSTM through ops/lstm_window_kernel.py: the top
    layer's h at t and t+1 from the window, then ONE output layer over
    [h_t; h_t1] (the t+1 rows detached, so they take a zero cotangent).
    The positions before t run no output layer: nothing reads it."""
    h_t, h_t1 = lstm_window_kernel.lstm_window(xs, active, params["layers"])
    y = apply_out(params, spec, torch.cat([h_t, h_t1]))
    B = xs.shape[0]
    return y[:B], y[B:].detach()


def bptt_counts(spec, xs) -> dict:
    """What a BPTT window over xs [B, P, n_in] runs, from the shapes:
    "bptt_cells", the cell applications of the forward (P positions x
    layers, the no-grad step to t+1 among them) and of the backward
    (P - 1 positions x layers); "bptt_macs", the multiply-adds of the
    forward's cells, one entry per layer (gates x (in h + h h) a row and
    position: 4 gates for LSTM, 2 for GRU, 1 for RNN)."""
    B, P = xs.shape[0], xs.shape[1]
    gates = {"LSTM": 4, "GRU": 2, "RNN": 1}[spec.kind]
    sizes = [spec.n_in] + list(spec.hidden)
    return {"bptt_cells": (2 * P - 1) * len(spec.hidden),
            "bptt_macs": tuple(B * P * gates * (a * h + h * h)
                               for a, h in zip(sizes[:-1], sizes[1:]))}


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
    inside a train chunk, so drawing up front equals drawing per step.
    Under a mesh each rank draws its batch // K from its own shard with
    its own generator (the JAX package's fold_in(key, axis_index))."""
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
    horizon cycle instead of the obsPerStep pacing. `presample`: the
    trainer may draw a chunk's uniform minibatch indices up front (every
    learner of the JAX package but RACER-ES). `capturable`: the trainer
    may capture the learner's train step, on presampled indices or with
    the prioritized draw inside it, and the env sweep that feeds it, as
    CUDA graphs (runtime/graphs.py): the step reads no device value back,
    keeps its shapes and updates every state tensor in its own storage.
    Every off-policy learner with a feed-forward net is, under any
    sampler of `rb.sample`; with a recurrent net only a learner whose
    BPTT step and acting carry are held under capture (`captures_bptt`:
    the V-RACER family). PPO is not, and a learner whose step is not held
    under capture says so (ACER, RACER-ES). DQN's, NAF's and DPG's
    recurrent steps stay refused: their target nets' windows, and NAF's
    and DPG's OU state beside the net's carry, have not been held
    captured against eager."""
    on_policy = False
    presample = True
    # the phases a traced train step stamps (`train_step(..., stamp=)`;
    # runtime/trainer.py): () for a learner whose step records only its
    # whole replay
    step_phases = ()
    # appended past observations in the minibatch gather: set from the MDP
    # by the learners that stack frames (RACER family, DQN)
    n_appended = 0

    # a recurrent net's truncated-BPTT step and acting carry are held
    # under capture (tests/test_torch_graphs.py)
    captures_bptt = False

    @property
    def capturable(self) -> bool:
        return (not self.on_policy
                and (self.cfg.nnType not in ("LSTM", "GRU", "RNN")
                     or self.captures_bptt))

    def sample_minibatch(self, rs: rb.ReplayState, gen, sample_override,
                         mesh=None):
        """Pinned (ep, t) indices (the trainer's presampled chunk, the
        parity tests), or a draw of batchSize (under a mesh batchSize // K
        from this rank's shard) from `gen` by the sampler
        cfg.dataSamplingAlgo names."""
        if sample_override is not None:
            ep, t = sample_override
        else:
            ep, t = rb.sample(gen, rs, local_batch(self.cfg, mesh),
                              self.cfg.dataSamplingAlgo)
        return gather_minibatch(rs, ep, t, n_appended=self.n_appended)

    @torch.no_grad()
    def refresh(self, rs: rb.ReplayState, n_grad_steps: float, mesh=None):
        """Every-1000-steps sweep (updateTrainingStatistics recompute
        branch + updateRewardsStats(.., rRateFac=10), Learner.cpp:74-100):
        returns recomputed with the OLD reward scaling, then the scaling
        updated. Under a mesh the returns are this rank's slots and the
        statistics global."""
        cfg = self.cfg
        rs = rb.recompute_returns(rs, cfg.gamma, cfg.lambda_,
                                  self.returns_mode)
        lr = anneal_rate(cfg.learnrate, n_grad_steps, cfg.epsAnneal)
        return rb.update_state_rew_stats(rs, 10.0 * lr, mesh=mesh)

    @torch.no_grad()
    def initialize_stats(self, rs: rb.ReplayState, mesh=None):
        """At training start: exact state/reward stats from the gathered
        data (global under a mesh), then all return estimators
        (Learner::initializeLearner, Learner.cpp:47-72)."""
        rs = rb.update_state_rew_stats(rs, 1.0, b_init=True, mesh=mesh)
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

    Invalid rows write nothing, as the JAX package drops them at a trash
    index (mode="drop"). A scatter here has no index to drop, so an
    invalid row writes what the first valid row writes, where it writes
    it; with no valid row, every row writes back the value row 0 read.
    No host sync: the step stays capturable."""
    tl, epl = mb.t.long(), mb.ep.long()
    valid = mb.valid
    # the first valid row, as a [1] index (a 0-d one reads it on the host)
    k = torch.argmax(valid.to(torch.int32)).view(1)
    tw, ew = torch.where(valid, tl, tl[k]), torch.where(valid, epl, epl[k])
    was_far = rb.is_far_policy(mb.rho_old, rs.cmax_ret, rs.cinv_ret)
    is_far = rb.is_far_policy(rho, rs.cmax_ret, rs.cinv_ret)
    delta_far = torch.where(valid, is_far.to(F32) - was_far.to(F32),
                            torch.zeros_like(rho))
    for dst, new in ((rs.rho_tm, rho), (rs.kl_tm, dkl),
                     (rs.delta_tm, delta), (rs.value_tm, value),
                     (rs.advantage_tm, advantage)):
        dst[tw, ew] = torch.where(valid[k], torch.where(valid, new, new[k]),
                                  dst[tw, ew])
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


def local_batch(cfg, mesh=None) -> int:
    """The minibatch of one rank: batchSize, split evenly over a mesh's
    ranks (HyperParameters::defineDistributedLearning)."""
    return cfg.batchSize // mesh.size if mesh is not None else cfg.batchSize


def psum_grads_(grads, mesh=None):
    """Under a mesh, sum the gradient tree across ranks before the
    optimizer step, as ONE flat buffer (the MPI_Iallreduce over the
    learners, Optimizer.cpp:110-119). In place; returns grads."""
    if mesh is not None:
        psum_tree_(mesh, [g for g in tree_leaves(grads) if g is not None])
    return grads


def post_step_processing(rs: rb.ReplayState, cfg, opt_step, delta_q,
                         mesh=None):
    """Per-grad-step memory processing (Learner::processMemoryBuffer,
    Learner.cpp:74-100): anneal CmaxRet, ReF-ER beta fixed point,
    maxAbsError EMA, each written into its scalar in place. Returns (rs,
    frac_off_policy). Under a mesh the stored and far-policy counts are
    global (one collective) and the batch's largest error is the largest
    on any rank (one more)."""
    n_step = opt_step.to(F32)
    rs = rb.update_cmax(rs, n_step, cfg.clipImpWeight, cfg.epsAnneal)
    counts = rb.stored_and_far(rs, mesh)
    rs, frac_off = rb.update_beta_alpha(rs, cfg.batchSize, cfg.maxTotObsNum,
                                        cfg.penalTol, counts=counts)
    n_stored = counts[0].to(F32)
    batch_max_err = torch.max(torch.abs(delta_q))
    if mesh is not None:
        pmax_(mesh, batch_max_err)
    learn_r = 0.1 * cfg.batchSize / torch.clamp(
        n_stored, min=float(cfg.maxTotObsNum))
    rs.max_abs_error.add_(learn_r * (batch_max_err - rs.max_abs_error))
    return rs, frac_off


def grad_stats(grads):
    """Gradient-moment tracking (StatsTracker analog): global norm and
    largest absolute leaf value."""
    leaves = tree_leaves(grads)
    sq = sum(torch.sum(x * x) for x in leaves)
    mx = torch.max(torch.stack([torch.max(torch.abs(x)) for x in leaves]))
    return {"grad_norm": torch.sqrt(sq), "grad_max": mx}


def default_metrics(dkl, rho, is_far, frac_off, beta, delta_q, v_val,
                    mesh=None):
    """The step's metrics; under a mesh each per-step mean is the mean
    over ranks (one collective), taken before the sqrt of rmse. `beta`
    is the replay's scalar, which the next step updates in place: the
    metric keeps a copy."""
    means = torch.stack([torch.mean(dkl), torch.mean(rho),
                         torch.mean(is_far.to(F32)),
                         torch.mean(delta_q * delta_q), torch.mean(v_val)])
    if mesh is not None:
        means = pmean(mesh, means)
    return {
        "avg_dkl": means[0],
        "avg_rho": means[1],
        "frac_far_batch": means[2],
        "frac_far_data": frac_off,
        "beta": beta.clone(),
        "rmse": torch.sqrt(means[3]),
        "avg_v": means[4],
    }


def step_tail_(rs: rb.ReplayState, mb: MiniBatch, cfg, opt_step, grads, rho,
               dkl, delta, value, advantage, v_next, is_far, mesh=None,
               net2v=False):
    """What a grad step does after Adam (step_tail_plain_), in place ->
    (rs, metrics). CUDA tensors take the hand-written kernel
    (ops/step_tail_kernel.py: two launches, bit-equal in the replay and
    its scalars; under a mesh a third after the chain's collectives);
    CPU tensors take the chain."""
    if rho.is_cuda:
        return step_tail_kernel.tail_(rs, mb, cfg, opt_step, grads, rho,
                                      dkl, delta, value, advantage, v_next,
                                      is_far, net2v=net2v, mesh=mesh)
    return step_tail_plain_(rs, mb, cfg, opt_step, grads, rho, dkl, delta,
                            value, advantage, v_next, is_far, mesh, net2v)


def step_tail_plain_(rs: rb.ReplayState, mb: MiniBatch, cfg, opt_step,
                     grads, rho, dkl, delta, value, advantage, v_next,
                     is_far, mesh=None, net2v=False):
    """The tail of the off-policy learners' grad step: the write-backs
    with the V(s_T) refresh (`net2v`: v_next is the net's raw output,
    turned into a value by scale_net2v first), the ReF-ER bookkeeping
    from Adam's new step count, the step metrics (`delta` the TD error,
    `value` the V estimate, `is_far` the batch's far-policy rows) and
    grad_stats -> (rs, metrics)."""
    if net2v:
        v_next = scale_net2v(v_next)
    rs = write_back_with_next(rs, mb, rho, dkl, delta, value, advantage,
                              v_next)
    rs, frac_off = post_step_processing(rs, cfg, opt_step, delta, mesh)
    metrics = default_metrics(dkl, rho, is_far, frac_off, rs.beta, delta,
                              value, mesh)
    metrics.update(grad_stats(grads))
    return rs, metrics

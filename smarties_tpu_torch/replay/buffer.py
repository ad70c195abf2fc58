"""On-device episode-slotted replay memory with ReF-ER state.

Port of smarties_tpu/replay/buffer.py (reference: ReplayMemory/
{MemoryBuffer,Episode,MemoryProcessing}.*): fixed-shape device tensors
over n_slots episode slots of max_len+1 steps with validity masks, so
ingestion, sampling, Retrace recomputation, ReF-ER bookkeeping and
forgetting are masked tensor ops with no host round-trip.

LAYOUT. The JAX package packs every per-step scalar into one record
`steps [E, L+1, R]` with mirrored slot metadata — a TPU cost-model choice
(full-row scatters; DEVIATIONS #15, #18). The port keeps one tensor per
field instead, stored TIME-MAJOR, [L+1, E, ...] (the `*_tm` fields): the
Retrace kernel (ops/retrace_kernel.py) walks t with one thread per slot,
and in this layout a warp's loads at each t are 32 neighbouring slots.
Both return sweeps hand the stored fields to that kernel's fused
in-place entry point as they are: one launch per sweep.
The public field views (`rewards`, `actions`, `mus`, `qret`, `rho`, `kl`,
`delta`, `value`, `advantage`, `states`) return the JAX package's
[E, L+1, ...] orientation as transposed views without a copy; `length`,
`ep_id` and `terminal` are the per-slot [E] tensors.

IN PLACE. Where the JAX package rebuilt arrays, the port writes the
stored tensors in place (index_put_, copy_, index_add_), the small
scalars (beta, alpha, Cmax, the statistics, the counters: 0-d device
tensors) and the sampling cache included; each function still returns
the state so call sites read like the JAX ones. No field is ever
rebound, so a CUDA graph of the step or the env sweep
(runtime/graphs.py) reads and writes the storage it captured. Nothing
here reads a device value back to the host.

Array layout (state-indexed time axis, see ops/returns.py):
  t in [0, T]   : states; V/A/Qret; rho/kl/delta (rho[T] == 0)
  t in [1, T]   : rewards (reward received on arriving at state t)
  t in [0, T-1] : actions and behavior policies mu

V(s_T) side-channel: `v_trunc [E]` holds the value at t == length of
each valid slot and the `value` view substitutes it there, as in the
JAX package (buffer.py:140-150, :246-254).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from smarties_tpu_torch.parallel.mesh import pmean, psum_, ring_shift

F32 = torch.float32
I32 = torch.int32


@dataclass
class ReplayState:
    # per-field storage, time-major [L+1, E, ...]
    states_tm: torch.Tensor      # [L1, E, dimS] raw (unstandardized),
    #                              f32, or uint8 for image observations
    rewards_tm: torch.Tensor     # [L1, E]
    actions_tm: torch.Tensor     # [L1, E, dimA]
    mus_tm: torch.Tensor         # [L1, E, dimPol]
    qret_tm: torch.Tensor        # [L1, E]
    rho_tm: torch.Tensor         # [L1, E]
    kl_tm: torch.Tensor          # [L1, E]
    delta_tm: torch.Tensor       # [L1, E]
    value_tm: torch.Tensor       # [L1, E] (entry at T stale: see v_trunc)
    advantage_tm: torch.Tensor   # [L1, E]
    # per-slot metadata
    slot_len: torch.Tensor       # [E] i32 transitions T
    slot_id: torch.Tensor        # [E] i32 episode id, -1 == empty
    slot_term: torch.Tensor      # [E] bool true terminal
    # ReF-ER / annealing scalars (MemoryBuffer.h:41-44), 0-d f32
    beta: torch.Tensor
    alpha: torch.Tensor
    cmax_ret: torch.Tensor
    cinv_ret: torch.Tensor
    # running state/reward statistics
    state_mean: torch.Tensor     # [dimS]
    state_std: torch.Tensor      # [dimS]
    state_scale: torch.Tensor    # [dimS] == 1/std
    rew_mean: torch.Tensor       # 0-d
    rew_std: torch.Tensor        # 0-d
    rew_scale: torch.Tensor      # 0-d
    # counters (ReplayStatsCounters.h), 0-d
    n_seen_eps: torch.Tensor     # i32
    n_seen_steps: torch.Tensor   # i32
    n_pruned_eps: torch.Tensor   # i32
    max_abs_error: torch.Tensor  # f32
    far_count: torch.Tensor      # [E] f32 far-policy steps per slot
    qret_stale: torch.Tensor     # [E] bool: committed since last sweep
    v_trunc: torch.Tensor        # [E] f32 value at t == length
    # uniform-sampling cache: cumsum(valid len) and episode start offset
    samp_csum: torch.Tensor      # [E] i32
    samp_start: torch.Tensor     # [E] i32

    # ---------------- field views, [E, L+1, ...] ----------------
    @property
    def states(self):
        return self.states_tm.transpose(0, 1)

    @property
    def rewards(self):
        return self.rewards_tm.t()

    @property
    def actions(self):
        return self.actions_tm.transpose(0, 1)

    @property
    def mus(self):
        return self.mus_tm.transpose(0, 1)

    @property
    def qret(self):
        return self.qret_tm.t()

    @property
    def rho(self):
        return self.rho_tm.t()

    @property
    def kl(self):
        return self.kl_tm.t()

    @property
    def delta(self):
        return self.delta_tm.t()

    @property
    def value(self):
        """Effective values: the stored field with v_trunc substituted at
        t == length of valid slots (a new time-major tensor, viewed)."""
        return self.value_with_trunc_tm().t()

    def value_with_trunc_tm(self):
        t = torch.arange(self.value_tm.shape[0], device=self.value_tm.device)
        at_T = (t[:, None] == torch.clamp(self.slot_len, 0, self.max_len
                                          )[None, :]) \
            & self.valid_slots()[None, :]
        return torch.where(at_T, self.v_trunc[None, :], self.value_tm)

    @property
    def advantage(self):
        return self.advantage_tm.t()

    @property
    def length(self):
        return self.slot_len

    @property
    def ep_id(self):
        return self.slot_id

    @property
    def terminal(self):
        return self.slot_term

    # ---------------- derived masks / counts ----------------
    @property
    def n_slots(self) -> int:
        return self.states_tm.shape[1]

    @property
    def max_len(self) -> int:
        return self.states_tm.shape[0] - 1

    def valid_slots(self):
        return self.slot_id >= 0

    def valid_steps_tm(self):
        """[L1, E] mask of transition indices t < T of valid episodes."""
        t = torch.arange(self.states_tm.shape[0], device=self.slot_len.device)
        return (t[:, None] < self.slot_len[None, :]) \
            & self.valid_slots()[None, :]

    def n_stored_steps(self):
        return torch.sum(torch.where(self.valid_slots(), self.slot_len,
                                     torch.zeros_like(self.slot_len)))

    def n_stored_eps(self):
        return torch.sum(self.valid_slots().to(I32))

    def scaled_rewards_tm(self):
        """(r - mean) * scale, time-major (Episode::scaledReward)."""
        return (self.rewards_tm - self.rew_mean) * self.rew_scale


def _full(value, dtype, device):
    """0-d device tensor from a python number, with no host-to-device
    copy (a fill kernel; torch.tensor(..., device=cuda) would copy and
    synchronise)."""
    return torch.full((), value, dtype=dtype, device=device)


def safe_mu(mdp) -> np.ndarray:
    """A numerically-safe behavior-policy vector for EMPTY slots: unit-
    stdev standard normal (continuous policies), uniform probabilities
    (discrete)."""
    if mdp.is_discrete:
        n = mdp.max_action_label
        return np.full((n,), 1.0 / n, np.float32)
    nA = mdp.dim_action
    return np.concatenate([np.zeros(nA), np.ones(nA)]).astype(np.float32)


def init_replay(n_slots: int, max_len: int, dim_state: int, dim_action: int,
                dim_policy: int, clip_imp_weight: float = 4.0, mu_init=None,
                device=None, state_dtype=F32) -> ReplayState:
    """Initial scalars follow MemoryBuffer.h:41-44: beta = 1e-4 when
    ReF-ER clipping is active, CmaxRet = 1 + C, CinvRet = 1/C. mu_init
    fills the behavior policies of empty slots (see safe_mu).

    state_dtype: storage type of the raw states; torch.uint8 for image
    observations (a padded slot layout of f32 pixels would not fit the
    card). The gather promotes to f32 when it standardizes."""
    E, L1 = n_slots, max_len + 1
    C = clip_imp_weight
    z = lambda *s: torch.zeros(s, dtype=F32, device=device)
    mus = z(L1, E, dim_policy)
    if mu_init is not None:
        mus[:] = torch.as_tensor(np.asarray(mu_init, np.float32),
                                 device=device)
    rs = ReplayState(
        states_tm=torch.zeros((L1, E, dim_state), dtype=state_dtype,
                              device=device),
        rewards_tm=z(L1, E),
        actions_tm=z(L1, E, dim_action), mus_tm=mus, qret_tm=z(L1, E),
        rho_tm=z(L1, E), kl_tm=z(L1, E), delta_tm=z(L1, E),
        value_tm=z(L1, E), advantage_tm=z(L1, E),
        slot_len=torch.zeros((E,), dtype=I32, device=device),
        slot_id=torch.full((E,), -1, dtype=I32, device=device),
        slot_term=torch.zeros((E,), dtype=torch.bool, device=device),
        beta=_full(1.0 if C <= 0 else 1e-4, F32, device),
        alpha=_full(0.5, F32, device),
        cmax_ret=_full(1.0 + C, F32, device),
        cinv_ret=_full(1.0 / C if C > 0 else 1.0, F32, device),
        state_mean=z(dim_state),
        state_std=torch.ones((dim_state,), dtype=F32, device=device),
        state_scale=torch.ones((dim_state,), dtype=F32, device=device),
        rew_mean=_full(0.0, F32, device), rew_std=_full(1.0, F32, device),
        rew_scale=_full(1.0, F32, device),
        n_seen_eps=_full(0, I32, device), n_seen_steps=_full(0, I32, device),
        n_pruned_eps=_full(0, I32, device),
        max_abs_error=_full(0.0, F32, device),
        far_count=z(E), qret_stale=torch.zeros((E,), dtype=torch.bool,
                                               device=device),
        v_trunc=z(E),
        samp_csum=torch.zeros((E,), dtype=I32, device=device),
        samp_start=torch.zeros((E,), dtype=I32, device=device))
    return rs


def rebuild_sample_cache(rs: ReplayState) -> ReplayState:
    """Refresh the [cumsum(len), episode-start] cache of uniform sampling
    (after every change of lengths/validity: commit and prune)."""
    lens = torch.where(rs.valid_slots(), rs.slot_len,
                       torch.zeros_like(rs.slot_len))
    torch.cumsum(lens, 0, dtype=I32, out=rs.samp_csum)
    torch.sub(rs.samp_csum, lens, out=rs.samp_start)
    return rs


# ---------------------------------------------------------------------------
# far-policy bookkeeping (Episode.h:28-33, :112-145)
# ---------------------------------------------------------------------------

def is_far_policy(rho, cmax, cinv):
    """1/C < rho < C test (Episode.h:28-33); no filtering when C <= 1."""
    off = (rho > cmax) | (rho < cinv)
    return (cmax > 1.0) & off


def episode_aggregates(rs: ReplayState):
    """Per-slot (frac_far_policy, avg_kl, avg_sq_err) [E] over the valid
    steps (Episode.h:83-85, computed from the stored fields)."""
    mask = rs.valid_steps_tm()
    maskf = mask.to(F32)
    n = torch.clamp(torch.sum(maskf, dim=0), min=1.0)
    far = is_far_policy(rs.rho_tm, rs.cmax_ret, rs.cinv_ret) & mask
    frac_far = torch.sum(far.to(F32), dim=0) / n
    avg_kl = torch.sum(rs.kl_tm * maskf, dim=0) / n
    avg_err = torch.sum(rs.delta_tm * rs.delta_tm * maskf, dim=0) / n
    return frac_far, avg_kl, avg_err


def far_count_exact(rs: ReplayState):
    """Per-slot exact far-policy counts [E]."""
    far = is_far_policy(rs.rho_tm, rs.cmax_ret, rs.cinv_ret) \
        & rs.valid_steps_tm()
    return torch.sum(far.to(F32), dim=0)


def n_far_policy_steps(rs: ReplayState):
    """Incrementally-maintained total (one [E] reduction)."""
    return torch.sum(rs.far_count).to(I32)


# ---------------------------------------------------------------------------
# ingestion: commit finished episodes from per-env in-progress buffers
# ---------------------------------------------------------------------------

def _keep_priority(rs: ReplayState, filter_algo: str):
    """Higher = kept longer; empty slots get -inf (filled first).
    getERfilterAlgo (MemoryProcessing.cpp:261-298): the oldest episode,
    the one with the largest far-policy fraction (farpolfrac), the largest
    mean KL (maxkldiv) or the smallest mean squared TD error (minerror)
    goes first."""
    if filter_algo in ("oldest", "default"):
        score = rs.slot_id.to(F32)
    elif filter_algo == "farpolfrac":
        score = -episode_aggregates(rs)[0]
    elif filter_algo == "maxkldiv":
        score = -episode_aggregates(rs)[1]
    elif filter_algo == "minerror":
        score = episode_aggregates(rs)[2]
    else:
        raise ValueError(f"unknown ERoldSeqFilter {filter_algo!r}")
    return torch.where(rs.valid_slots(), score,
                       torch.full_like(score, -float("inf")))


def commit_episodes(rs: ReplayState, ep_states, ep_actions, ep_mus,
                    ep_rewards, ep_value, ep_advantage, ep_qret, ep_rho,
                    ep_length, ep_terminal, done_mask, max_tot_obs: int,
                    filter_algo: str = "oldest") -> ReplayState:
    """Scatter finished episodes into replay slots, then prune
    (pushBackEpisode + applyEpisodesRemovalAlgo, MemoryBuffer.cpp:479-520,
    MemoryProcessing.cpp:327-351). Per-lane inputs in the JAX package's
    orientation: ep_states [V, L+1, dimS], ep_actions [V, L+1, dimA],
    ep_mus [V, L+1, dimPol], ep_rewards/ep_value/ep_advantage/ep_qret/
    ep_rho [V, L+1], ep_length [V] i32, ep_terminal and done_mask [V]
    bool. kl and delta start at zero. Writes the replay in place.

    Victim slots: the lowest keep-priority slots, empty ones first. The
    sort must be STABLE — every empty slot ties at -inf, and jnp.argsort
    is stable while torch.argsort is not by default.

    The JAX package scatters the done lanes and drops the others at a
    trash index (`.at[tgt].set(mode="drop")`), which torch has no twin
    for; selecting the done lanes first would need their count on the
    host (a synchronisation). Instead EVERY lane gets a distinct slot: the
    done lanes the worst slots in priority order, as in the JAX package,
    the other lanes the slots after those, where they write back the
    slot's own current values. No index repeats, so index_put_ is
    deterministic, and nothing but the done lanes' slots changes.
    """
    V = done_mask.shape[0]
    if V > rs.n_slots:
        raise ValueError(f"{V} lanes cannot commit into {rs.n_slots} slots")
    prio = _keep_priority(rs, filter_algo)
    order = torch.argsort(prio, stable=True)          # ascending: worst first
    done_i = done_mask.to(I32)
    done_rank = torch.cumsum(done_i, 0, dtype=I32) - 1
    n_done = torch.sum(done_i)
    rest_rank = torch.cumsum(1 - done_i, 0, dtype=I32) - 1
    rank = torch.where(done_mask, done_rank, n_done + rest_rank)
    tgt = order[rank.long()]                            # [V] distinct slots
    new_ids = rs.n_seen_eps + done_rank

    def put_tm(dst, src):
        """dst [L1, E, ...] <- src [L1, V, ...] on the done lanes."""
        m = done_mask.view((1, V) + (1,) * (src.dim() - 2))
        dst[:, tgt] = torch.where(m, src, dst[:, tgt])

    def put(dst, src):
        dst[tgt] = torch.where(done_mask, src, dst[tgt])

    L1 = rs.states_tm.shape[0]
    zero = torch.zeros((L1, V), dtype=F32, device=done_mask.device)
    put_tm(rs.states_tm, ep_states.transpose(0, 1).to(rs.states_tm.dtype))
    put_tm(rs.rewards_tm, ep_rewards.t())
    put_tm(rs.actions_tm, ep_actions.transpose(0, 1))
    put_tm(rs.mus_tm, ep_mus.transpose(0, 1))
    put_tm(rs.qret_tm, ep_qret.t())
    put_tm(rs.rho_tm, ep_rho.t())
    put_tm(rs.kl_tm, zero)
    put_tm(rs.delta_tm, zero)
    put_tm(rs.value_tm, ep_value.t())
    put_tm(rs.advantage_tm, ep_advantage.t())
    # v_trunc invariant: the arriving episode's value at t == length
    lens = torch.clamp(ep_length.to(torch.long), 0, rs.max_len)
    v_at_T = torch.gather(ep_value, 1, lens[:, None])[:, 0]
    put(rs.slot_len, ep_length.to(I32))
    put(rs.slot_id, new_ids.to(I32))
    put(rs.slot_term, ep_terminal)
    # fresh episodes arrive with rho == 1 everywhere: zero far steps
    put(rs.far_count, torch.zeros((V,), dtype=F32, device=done_mask.device))
    put(rs.qret_stale, torch.ones((V,), dtype=torch.bool,
                                  device=done_mask.device))
    put(rs.v_trunc, v_at_T)
    rs.n_seen_eps.add_(n_done.to(I32))
    rs.n_seen_steps.add_(torch.sum(
        torch.where(done_mask, ep_length, torch.zeros_like(ep_length))
    ).to(I32))
    return prune_to_capacity(rs, max_tot_obs, filter_algo)


def prune_to_capacity(rs: ReplayState, max_tot_obs: int, filter_algo: str):
    """Invalidate the lowest-priority episodes until the total fits
    (applyEpisodesRemovalAlgo, MemoryProcessing.cpp:327-351): in keep-
    priority-descending order keep episode i iff the steps before it are
    <= maxTotObs. The stable sort keeps ties in slot order, as jnp's.
    Refreshes the sampling cache."""
    prio = _keep_priority(rs, filter_algo)
    order = torch.argsort(-prio, stable=True)           # best kept first
    valid = rs.valid_slots()
    lens = torch.where(valid, rs.slot_len,
                       torch.zeros_like(rs.slot_len))[order]
    csum_before = torch.cumsum(lens, 0, dtype=I32) - lens
    keep_sorted = csum_before <= max_tot_obs
    keep = torch.empty_like(keep_sorted)
    keep[order] = keep_sorted                           # a permutation
    keep = keep & valid
    pruned = rs.n_stored_eps() - torch.sum(keep.to(I32))
    rs.slot_len.copy_(torch.where(keep, rs.slot_len,
                                  torch.zeros_like(rs.slot_len)))
    rs.slot_id.copy_(torch.where(keep, rs.slot_id,
                                 torch.full_like(rs.slot_id, -1)))
    rs.far_count.copy_(torch.where(keep, rs.far_count,
                                   torch.zeros_like(rs.far_count)))
    rs.n_pruned_eps.add_(pruned.to(I32))
    return rebuild_sample_cache(rs)


def clear_all(rs: ReplayState) -> ReplayState:
    """Invalidate every episode (PPO's epoch-end clearAll, PPO.cpp:105-112):
    lengths 0, ids -1, the terminal flags as they are, the sampling cache
    rebuilt. As in the JAX package the stored steps, the far counts and
    the counters of seen episodes and steps stay (new episode ids go on
    from n_seen_eps). In place."""
    rs.slot_len.zero_()
    rs.slot_id.fill_(-1)
    return rebuild_sample_cache(rs)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def sample_uniform_from_flat(rs: ReplayState, flat):
    """(ep, t) of flat transition indices in [0, total): searchsorted
    (side="right", i.e. right=True) on the cached cumulative lengths.
    Any leading shape."""
    csum = rs.samp_csum
    ep = torch.searchsorted(csum, flat.to(csum.dtype).contiguous(),
                            right=True)
    ep = torch.clamp(ep, 0, rs.n_slots - 1)
    t = flat.to(I32) - rs.samp_start[ep]
    return ep.to(I32), t.to(I32)


def draw_flat(gen: torch.Generator, rs: ReplayState, shape):
    """Uniform flat indices in [0, max(total, 1)) without reading the
    total back: 62 random bits reduced modulo the total (a bias below
    total / 2^62)."""
    total = torch.clamp(rs.samp_csum[-1].to(torch.int64), min=1)
    bits = torch.randint(0, 2 ** 62, tuple(shape), generator=gen,
                         dtype=torch.int64, device=total.device)
    return bits % total


def sample_uniform(gen: torch.Generator, rs: ReplayState, batch: int):
    """Uniform over stored transitions -> (ep_idx, t_idx) [batch]
    (Sample_uniform, Sampling.cpp:49-99; iid draws)."""
    return sample_uniform_from_flat(rs, draw_flat(gen, rs, (batch,)))


# The other samplers (Sampling.cpp:55-336). Each has a function that
# returns its probability vector and a draw by inverse CDF from uniforms
# in [0, 1): `u` injects them (the tests, and card-against-CPU checks),
# otherwise `gen` draws them on the replay's device. torch.multinomial
# takes at most 2^24 categories and the step axis has E * L1 entries, so
# nothing here builds on it. Flat step indices are ep * L1 + t, the JAX
# package's order, which also fixes the rank of tied errors.

def _uniforms(gen, shape, device, u=None):
    if u is not None:
        return u
    return torch.rand(tuple(shape), generator=gen, dtype=F32, device=device)


def draw_from_probs(p, u):
    """Inverse-CDF draw: the index i with cdf[i-1] <= u * total < cdf[i],
    for each u in [0, 1). The cumulative sum is taken in f64: an f32 sum
    over millions of entries loses the small probabilities. Entries of
    probability 0 are never drawn."""
    cdf = torch.cumsum(p.to(torch.float64), 0)
    x = u.to(torch.float64) * cdf[-1]
    idx = torch.searchsorted(cdf, x.contiguous(), right=True)
    return torch.clamp(idx, max=p.shape[0] - 1)


def _flat_valid(rs: ReplayState):
    """Valid-step mask flattened as [E * L1] (ep-major)."""
    return rs.valid_steps_tm().t().reshape(-1)


def _split_flat(rs: ReplayState, flat):
    L1 = rs.states_tm.shape[0]
    return (flat // L1).to(I32), (flat % L1).to(I32)


def episode_probs(rs: ReplayState):
    """[E]: uniform over the stored episodes."""
    p = rs.valid_slots().to(F32)
    return p / torch.clamp(torch.sum(p), min=1.0)


def sample_episodes(gen, rs: ReplayState, batch: int, u=None):
    """Uniform over stored episodes (bSampleEpisodes, Sampling.cpp:55-81)
    -> slot indices [batch]."""
    u = _uniforms(gen, (batch,), rs.slot_id.device, u)
    return draw_from_probs(episode_probs(rs), u).to(I32)


def per_rank_probs(rs: ReplayState):
    """[E * L1]: p ~ 1 / rank of |TD error| among the stored steps. The
    sort is stable, as jnp.argsort is: fresh steps all have delta == 0 and
    tie, and an unstable sort would rank them otherwise."""
    mask = _flat_valid(rs)
    err = torch.where(mask, torch.abs(rs.delta_tm.t().reshape(-1)),
                      torch.full((), -1.0, device=mask.device))
    n = err.shape[0]
    order = torch.argsort(-err, stable=True)            # descending error
    rank = torch.empty((n,), dtype=F32, device=err.device)
    rank[order] = torch.arange(1, n + 1, dtype=F32, device=err.device)
    p = torch.where(mask, 1.0 / rank, torch.zeros_like(rank))
    return p / torch.sum(p)


def sample_per_rank(gen, rs: ReplayState, batch: int, beta_annealed=1.0,
                    u=None):
    """Rank-based prioritized sampling (TSample_impRank,
    Sampling.cpp:101-169) -> (ep, t, importance weight). The weight is
    (1 / (N p)) ** beta normalised by its max (MemoryBuffer.cpp:409-427);
    the reference computes it and never applies it to a gradient
    (Approximator.h:196 is commented out), and neither does the port."""
    p = per_rank_probs(rs)
    u = _uniforms(gen, (batch,), p.device, u)
    flat = draw_from_probs(p, u)
    n_data = torch.clamp(rs.n_stored_steps().to(F32), min=1.0)
    w = (1.0 / (n_data * p[flat])) ** beta_annealed
    ep, t = _split_flat(rs, flat)
    return ep, t, w / torch.max(w)


def per_err_probs(rs: ReplayState):
    """[E * L1]: p ~ |delta| + 1e-3 over the stored steps."""
    mask = _flat_valid(rs)
    a = torch.abs(rs.delta_tm.t().reshape(-1)) + 1e-3
    p = torch.where(mask, a, torch.zeros_like(a))
    return p / torch.clamp(torch.sum(p), min=1e-9)


def sample_per_err(gen, rs: ReplayState, batch: int, u=None):
    """TD-error-proportional prioritized sampling (TSample_impErr,
    Sampling.cpp:172-225) -> (ep, t)."""
    p = per_err_probs(rs)
    u = _uniforms(gen, (batch,), p.device, u)
    return _split_flat(rs, draw_from_probs(p, u))


def per_seq_probs(rs: ReplayState):
    """[E]: episodes weighted by their mean squared TD error + 1e-3."""
    avg_err = episode_aggregates(rs)[2]
    p = torch.where(rs.valid_slots(), avg_err + 1e-3,
                    torch.zeros_like(avg_err))
    return p / torch.clamp(torch.sum(p), min=1e-9)


def sample_per_seq(gen, rs: ReplayState, batch: int, u=None):
    """Episode-level prioritized sampling (Sample_impSeq,
    Sampling.cpp:229-296): an episode by per_seq_probs, then a uniform
    step within it. u: [2, batch] uniforms (episode draw, step draw)."""
    u = _uniforms(gen, (2, batch), rs.slot_id.device, u)
    ep = draw_from_probs(per_seq_probs(rs), u[0])
    t = (u[1].to(F32) * rs.slot_len[ep].to(F32)).to(I32)
    return ep.to(I32), torch.clamp(t, 0, rs.max_len)


def sample(gen, rs: ReplayState, batch: int, algo: str = "uniform", u=None):
    """Sampler dispatch on dataSamplingAlgo (Sampling.cpp:298-336) ->
    (ep, t) [batch]. `u` pins the uniforms of the prioritized samplers."""
    if algo in ("uniform", "default"):
        return sample_uniform(gen, rs, batch)
    if algo == "PERrank":
        return sample_per_rank(gen, rs, batch, u=u)[:2]
    if algo == "PERerr":
        return sample_per_err(gen, rs, batch, u=u)
    if algo == "PERseq":
        return sample_per_seq(gen, rs, batch, u=u)
    raise ValueError(f"unknown dataSamplingAlgo {algo!r}")


# ---------------------------------------------------------------------------
# ReF-ER rule 2 (beta fixed point) + annealed C (rule 1 schedule)
# ---------------------------------------------------------------------------

def stored_and_far(rs: ReplayState, mesh=None):
    """(stored steps, far-policy steps) as 0-d i64 tensors; under a mesh
    the sums over every rank's shard, in ONE collective (the
    MPI_Iallreduce of MemoryProcessing.cpp:56-58)."""
    counts = torch.stack([rs.n_stored_steps().to(torch.int64),
                          n_far_policy_steps(rs).to(torch.int64)])
    if mesh is not None:
        psum_(mesh, counts)
    return counts[0], counts[1]


def update_beta_alpha(rs: ReplayState, batch_size: int, max_tot_obs: int,
                      penal_tol: float, mesh=None, counts=None):
    """beta/alpha fixed-point iteration (MemoryProcessing::updateCounters,
    MemoryProcessing.cpp:46-92): learnRefer = 0.1 B / max(maxN, nData);
    beta -> 0 if fracOffPol > D else -> 1. Returns (rs, frac_off).
    batch_size and max_tot_obs are GLOBAL totals; under a mesh n_data
    and n_far are summed across ranks (stored_and_far), unless the
    caller passes those global `counts` already."""
    n_data, n_far = counts if counts is not None else stored_and_far(
        rs, mesh)
    n_data = n_data.to(F32)
    frac_off = n_far.to(F32) / torch.clamp(n_data, min=1.0)
    learn_r = 0.1 * batch_size / torch.clamp(n_data, min=float(max_tot_obs))

    def fix_point(val, go_to_0):
        lr = torch.minimum(learn_r, val)
        to0 = (1 - lr) * val
        to1 = (1 - lr) * val + torch.minimum(learn_r, 1 - val)
        return torch.where(go_to_0, to0, to1)

    rs.beta.copy_(fix_point(rs.beta, frac_off > penal_tol))
    rs.alpha.copy_(fix_point(rs.alpha,
                             torch.abs(penal_tol - frac_off) < 1e-3))
    return rs, frac_off


def update_cmax(rs: ReplayState, n_grad_steps, clip_imp_weight: float,
                eps_anneal: float):
    """CmaxRet = 1 + annealRate(C, step, epsAnneal)
    (updateTrainingStatistics, MemoryProcessing.cpp:193-197)."""
    c = 1.0 + clip_imp_weight / (1.0 + n_grad_steps.to(F32) * eps_anneal)
    rs.cmax_ret.copy_(c)
    rs.cinv_ret.copy_(1.0 / c)
    return rs


# ---------------------------------------------------------------------------
# state/reward running statistics
# ---------------------------------------------------------------------------

# f32 elements of the states that one chunk of the statistics pass turns
# into a temporary (1 GiB)
STATS_CHUNK_ELEMS = 1 << 28


def _state_moments(rs: ReplayState):
    """(sum over the stored states of (x - state_mean), of its square)
    [dimS] f32 each, and the count of stored states. Reduced over as many
    rows of the time axis at a time as STATS_CHUNK_ELEMS allows, at least
    one: a uint8 replay of pixels is never promoted to f32 as a whole,
    which would take four times its size twice over. Each chunk's f32
    partial sums are added up in f64. With one chunk the result is that
    of the unchunked reduction."""
    L1, E, D = rs.states_tm.shape
    chunk_rows = max(1, STATS_CHUNK_ELEMS // max(1, E * D))
    dev = rs.states_tm.device
    t = torch.arange(L1, device=dev)[:, None]
    smask = ((t <= rs.slot_len[None, :]) & rs.valid_slots()[None, :]).to(F32)
    s1 = torch.zeros((D,), dtype=torch.float64, device=dev)
    s2 = torch.zeros((D,), dtype=torch.float64, device=dev)
    for r0 in range(0, L1, chunk_rows):
        ds = rs.states_tm[r0:r0 + chunk_rows].to(F32, copy=True)
        ds = ds.sub_(rs.state_mean).mul_(smask[r0:r0 + chunk_rows, :, None])
        s1 += torch.sum(ds, dim=(0, 1))
        s2 += torch.sum(ds.square_(), dim=(0, 1))
    return s1.to(F32), s2.to(F32), torch.sum(smask)


def update_state_rew_stats(rs: ReplayState, learn_rate, b_init: bool = False,
                           adapt_state_scale: bool = True, mesh=None):
    """Annealed running mean/std of stored states and rewards
    (MemoryProcessing::updateRewardsStats, MemoryProcessing.cpp:94-185):
      mean += lr * Evar;  var = Evar2 - Evar^2 (2lr - lr^2);
      std += lr (sqrt(var) - std);  scale = 1/std.
    b_init uses lr == 1 (exact stats). learn_rate is a python number;
    it becomes a 0-d f32 device tensor, as the JAX package computes it.
    The states are reduced in chunks of the time axis (_state_moments).
    Under a mesh every moment and count is summed across ranks, in ONE
    collective (the StateRewRdx allreduce, MemoryProcessing.cpp:139-150)."""
    dev = rs.rew_mean.device
    wr = _full(1.0 if b_init else min(1.0, float(learn_rate)), F32, dev)
    ws = wr if adapt_state_scale else _full(0.0, F32, dev)

    L1 = rs.states_tm.shape[0]
    t = torch.arange(L1, device=dev)[:, None]
    valid = rs.valid_slots()[None, :]
    rmask = ((t >= 1) & (t <= rs.slot_len[None, :]) & valid).to(F32)
    dr = (rs.rewards_tm - rs.rew_mean) * rmask
    sum_s, sum2_s, scount = _state_moments(rs)
    sums = torch.cat([torch.stack([torch.sum(rmask), torch.sum(dr),
                                   torch.sum(dr * dr), scount]),
                      sum_s, sum2_s])
    if mesh is not None:
        psum_(mesh, sums)
    count = torch.clamp(sums[0], min=1.0)
    evar_r = sums[1] / count
    evar2_r = sums[2] / count

    def upd_(mean, std, scale, lr, evar, evar2):
        var = evar2 - evar * evar * (2 * lr - lr * lr)
        var = torch.clamp(var, min=float(np.finfo(np.float32).eps))
        mean.add_(lr * evar)
        std.add_(lr * (torch.sqrt(var) - std))
        torch.reciprocal(std, out=scale)

    upd_(rs.rew_mean, rs.rew_std, rs.rew_scale, wr, evar_r, evar2_r)

    D = sum_s.shape[0]
    scount = torch.clamp(sums[3], min=1.0)
    evar_s = sums[4:4 + D] / scount
    evar2_s = sums[4 + D:] / scount
    upd_(rs.state_mean, rs.state_std, rs.state_scale, ws, evar_s, evar2_s)
    return rs


# ---------------------------------------------------------------------------
# return-estimator sweeps (the four K1 sites go through these two)
# ---------------------------------------------------------------------------

def _sweep_returns_(rs: ReplayState, select, gamma, lam, mode,
                    zero_unselected: bool):
    """qret of the `select` slots, written into rs.qret_tm in place; the
    other slots keep their row or, with `zero_unselected`, get zeros.

    retrace/GAE: one call of the fused sweep over the stored time-major
    fields (ops/retrace_kernel.retrace_sweep_: one kernel launch on CUDA
    tensors, its plain version on the CPU). retraceExplore is not affine:
    it keeps the sequential recursion on materialised inputs."""
    if mode in ("retrace", "GAE"):
        from smarties_tpu_torch.ops.retrace_kernel import retrace_sweep_
        retrace_sweep_(rs.qret_tm, rs.rewards_tm, rs.value_tm,
                       rs.advantage_tm, rs.rho_tm, rs.v_trunc, rs.slot_len,
                       rs.slot_term, select, rs.rew_mean, rs.rew_scale,
                       gamma, lam, mode, zero_unselected)
        return
    from smarties_tpu_torch.ops.returns import sequential_returns
    q = sequential_returns(
        rs.scaled_rewards_tm().t(), rs.value_with_trunc_tm().t(),
        rs.advantage_tm.t(), rs.rho_tm.t(), rs.slot_len, rs.slot_term,
        gamma, lam, mode, err_baseline=rs.max_abs_error).t()
    other = torch.zeros_like(rs.qret_tm) if zero_unselected else rs.qret_tm
    rs.qret_tm.copy_(torch.where(select[None, :], q, other))


def refresh_new_returns(rs: ReplayState, gamma: float, lam: float,
                        mode: str = "retrace") -> ReplayState:
    """Return estimates for freshly-committed episodes only (qret_stale
    slots): the at-ingest Retrace of MemoryBuffer::terminateCurrentEpisode
    (MemoryBuffer.cpp:118-170), batched once per rollout chunk. Writes
    qret in place; the other slots' rows are neither read nor written."""
    if mode != "none":
        _sweep_returns_(rs, rs.qret_stale & rs.valid_slots(), gamma, lam,
                        mode, zero_unselected=False)
    rs.qret_stale.zero_()
    return rs


def recompute_returns(rs: ReplayState, gamma: float, lam: float,
                      mode: str = "retrace") -> ReplayState:
    """Backward recursion over every stored episode (at ingest and every
    1000 grad steps, MemoryProcessing.cpp:187-259, :460-481); also resyncs
    the incremental far-policy counts exactly. Writes in place; empty
    slots get zeros."""
    rs.far_count.copy_(far_count_exact(rs))
    rs.qret_stale.zero_()
    if mode == "none":
        return rs
    _sweep_returns_(rs, rs.valid_slots(), gamma, lam, mode,
                    zero_unselected=True)
    return rs


def rebalance_shards(rs: ReplayState, mesh, k_max: int = 8,
                     max_tot_obs: int = 2 ** 30,
                     filter_algo: str = "oldest") -> ReplayState:
    """Cross-shard episode balancing at the refresh cadence: a rank
    holding more episodes than the mean over ranks ships up to k_max of
    its lowest keep-priority slots to its ring neighbour (rank + 1) % K
    (the round-robin episode sharing of DataCoordinator.cpp:91-112; JAX
    package: buffer.py::rebalance_shards). In place.

    As in the JAX package: the candidates are the first k_max slots in
    keep-priority order, where empty slots come first, and only valid
    ones ship; a shipped record travels with kl = delta = 0 and with its
    v_trunc in the value entry at T. The sender invalidates the shipped
    slots (length 0, id -1, far count 0); the receiver commits them
    through commit_episodes (new ids from its n_seen_eps) and restores
    n_seen_eps / n_seen_steps: they migrated, they are not new."""
    k = min(k_max, rs.n_slots)
    n_eps = rs.n_stored_eps().to(F32)
    n_ship = torch.clamp((n_eps - pmean(mesh, n_eps)).to(I32), 0, k)
    order = torch.argsort(_keep_priority(rs, filter_algo), stable=True)
    take = torch.arange(k, device=order.device)
    slots = order[:k]
    ship = (take < n_ship) & (rs.slot_id[slots] >= 0)
    T = torch.clamp(rs.slot_len[slots].long(), 0, rs.max_len)
    value = rs.value_tm[:, slots].t().clone()
    value[take, T] = rs.v_trunc[slots]
    sent = ring_shift(mesh, dict(
        states=rs.states_tm[:, slots].transpose(0, 1),
        actions=rs.actions_tm[:, slots].transpose(0, 1),
        mus=rs.mus_tm[:, slots].transpose(0, 1),
        rewards=rs.rewards_tm[:, slots].t(), value=value,
        advantage=rs.advantage_tm[:, slots].t(),
        qret=rs.qret_tm[:, slots].t(), rho=rs.rho_tm[:, slots].t(),
        length=rs.slot_len[slots], terminal=rs.slot_term[slots],
        ship=ship))

    # sender side: invalidate the shipped slots
    drop = torch.zeros_like(rs.qret_stale)
    drop[slots] = ship
    rs.slot_len.masked_fill_(drop, 0)
    rs.slot_id.masked_fill_(drop, -1)
    rs.far_count.masked_fill_(drop, 0.0)

    # receiver side: commit the neighbour's episodes as migrated
    seen_eps, seen_steps = rs.n_seen_eps.clone(), rs.n_seen_steps.clone()
    rs = commit_episodes(
        rs, sent["states"], sent["actions"], sent["mus"], sent["rewards"],
        sent["value"], sent["advantage"], sent["qret"], sent["rho"],
        sent["length"], sent["terminal"], sent["ship"], max_tot_obs,
        filter_algo)
    rs.n_seen_eps.copy_(seen_eps)
    rs.n_seen_steps.copy_(seen_steps)
    return rs

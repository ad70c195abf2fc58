"""Vectorized rollout collection: acting + env stepping + episode commit.

Port of smarties_tpu/replay/collector.py (reference serving stack:
Core/Master.cpp:118-144, Core/Worker.cpp:144-186, Learner.cpp:30-45): all
V environments advance in lockstep, action selection is one batched
network forward, and finished episodes are scattered into the replay
(MemoryBuffer::terminateCurrentEpisode, MemoryBuffer.cpp:118-170). Their
Retrace estimates are computed once per chunk afterwards
(buffer.refresh_new_returns).

The per-agent in-progress episodes are fixed-shape per-env tensors,
time-major [L+1, V, ...] like the replay, with a step cursor per lane,
written in place. `rollout_chunk` is a Python loop over `one_step`; no
step reads a device value back to the host. The learner's per-env acting
carry (`rnn`: the Ornstein-Uhlenbeck state of DPG and NAF) rides in the
carry and is zeroed for each lane whose episode ends.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from smarties_tpu_torch.models.net import tree_map
from smarties_tpu_torch.replay.buffer import ReplayState, commit_episodes

F32 = torch.float32
I32 = torch.int32


class InProgress(NamedTuple):
    states: torch.Tensor      # [L1, V, dimS_obs]
    actions: torch.Tensor     # [L1, V, dimA]
    mus: torch.Tensor         # [L1, V, dimPol]
    rewards: torch.Tensor     # [L1, V]
    value: torch.Tensor       # [L1, V] V(s_t) recorded while acting
    advantage: torch.Tensor   # [L1, V] A(s_t, a_t) recorded while acting
    t: torch.Tensor           # [V] i32 cursor == steps taken so far
    cum_reward: torch.Tensor  # [V] running return (Episode.totR)


def init_inprogress(n_envs: int, max_len: int, dim_obs: int,
                    dim_action: int, dim_policy: int,
                    device=None, state_dtype=F32) -> InProgress:
    """state_dtype: the replay's state storage type (uint8 for pixels);
    observations are cast to it as they are written."""
    V, L1 = n_envs, max_len + 1
    z = lambda *s: torch.zeros(s, dtype=F32, device=device)
    return InProgress(
        states=torch.zeros((L1, V, dim_obs), dtype=state_dtype,
                           device=device),
        actions=z(L1, V, dim_action),
        mus=z(L1, V, dim_policy), rewards=z(L1, V), value=z(L1, V),
        advantage=z(L1, V), t=torch.zeros((V,), dtype=I32, device=device),
        cum_reward=z(V))


def _reset_lanes(ip: InProgress, mask) -> InProgress:
    """Zero the finished lanes (in place for the buffers)."""
    for x in (ip.states, ip.actions, ip.mus, ip.rewards, ip.value,
              ip.advantage):
        x.masked_fill_(mask.view((1, -1) + (1,) * (x.dim() - 2)), 0)
    return ip._replace(t=torch.where(mask, torch.zeros_like(ip.t), ip.t),
                       cum_reward=torch.where(mask,
                                              torch.zeros_like(ip.cum_reward),
                                              ip.cum_reward))


class RolloutGens(NamedTuple):
    """The rollout's random streams: acting noise and env resets."""
    act: torch.Generator
    reset: torch.Generator


class RolloutCarry(NamedTuple):
    replay: ReplayState
    inprog: InProgress
    env_state: object
    gens: RolloutGens
    # per-env acting carry (AgentContext, Network/ThreadContext.h:19-100)
    rnn: tuple = ()


def make_rollout_chunk(env_module, mdp, act_fn: Callable, max_tot_obs: int,
                       filter_algo: str = "oldest"):
    """Build `rollout_chunk(params, carry, n_steps) -> (carry, logs)`.

    act_fn(params, obs_std, gen, rnn) -> (learner_action [V, dimA],
    mu [V, dimPol], value [V], adv [V], rnn) is the learner's acting head.
    logs: (done [k, V], length [k, V], ret [k, V]) for the host-side
    cumulative_rewards.dat writer (MemoryBuffer.cpp:491-513)."""

    def one_step(params, carry: RolloutCarry):
        rs, ip, es, gens, rnn = carry
        V = ip.t.shape[0]
        L1 = ip.states.shape[0]
        lane = torch.arange(V, device=ip.t.device)

        obs = mdp.observed(env_module.observe(es))
        tcur = ip.t.long()
        ip.states[tcur, lane] = obs.to(ip.states.dtype)
        k_app = mdp.n_appended_obs
        if k_app:
            # frame stacking from the in-progress buffer, clamped at the
            # episode start (Episode::standardizedState)
            offs = torch.arange(k_app + 1, device=tcur.device)
            tj = torch.clamp(tcur[:, None] - offs[None, :], min=0)
            frames = (ip.states[tj, lane[:, None]]
                      - rs.state_mean) * rs.state_scale      # [V, k+1, dimS]
            obs_std = frames.reshape(V, -1)
        else:
            obs_std = (obs - rs.state_mean) * rs.state_scale
        act, mu, val, adv, rnn = act_fn(params, obs_std, gens.act, rnn)
        ip.actions[tcur, lane] = act
        ip.mus[tcur, lane] = mu
        ip.value[tcur, lane] = val
        ip.advantage[tcur, lane] = adv

        es2, reward, done, terminal = env_module.step(
            es, mdp.learner_to_env_action(act))
        tnew = tcur + 1
        # force-truncate episodes hitting the storage cap (MAX_SEQ_LEN)
        done = done | (tnew >= L1 - 1)
        ip.rewards[tnew, lane] = reward
        ip = ip._replace(cum_reward=ip.cum_reward + reward,
                         t=tnew.to(I32))
        # the final state of finished lanes; V(s_T) stays 0 at ingest like
        # the reference (Episode::finalize; refreshed by training)
        obs2 = mdp.observed(env_module.observe(es2))
        ip.states[tnew, lane] = torch.where(done[:, None],
                                            obs2.to(ip.states.dtype),
                                            ip.states[tnew, lane])

        # rho template: 1 for t < T, 0 at T (Episode::finalize,
        # Episode.cpp:244-267); qret is filled by the chunk's sweep
        tgrid = torch.arange(L1, device=tnew.device)[None, :]
        rho_ep = (tgrid < tnew[:, None]).to(F32)
        rs = commit_episodes(
            rs, ip.states.transpose(0, 1), ip.actions.transpose(0, 1),
            ip.mus.transpose(0, 1), ip.rewards.t(), ip.value.t(),
            ip.advantage.t(), torch.zeros_like(rho_ep), rho_ep, ip.t,
            terminal, done, max_tot_obs, filter_algo)

        log = (done, ip.t, ip.cum_reward)
        ip = _reset_lanes(ip, done)
        es2 = env_module.reset_where(es2, done, gens.reset)
        rnn = tree_map(lambda h: torch.where(
            done.view((-1,) + (1,) * (h.dim() - 1)), torch.zeros_like(h), h),
            rnn)
        return RolloutCarry(rs, ip, es2, gens, rnn), log

    def rollout_chunk(params, carry: RolloutCarry, n_steps: int):
        logs = []
        for _ in range(n_steps):
            carry, log = one_step(params, carry)
            logs.append(log)
        return carry, tuple(torch.stack(x) for x in zip(*logs))

    return rollout_chunk

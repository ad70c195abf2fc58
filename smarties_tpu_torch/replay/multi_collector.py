"""Vectorized rollout collection for COMPETING agents: one shared env,
one learner per agent, each with its own policy and replay.

Port of smarties_tpu/replay/multi_collector.py (the reference's per-agent
MDP serving, Core/Environment.h:84-97 initDescriptors(true),
Core/Worker.cpp:144-188: each agent's state routes to learners[localID]):
every env step computes each agent's actions with ITS learner's
parameters, steps the joint env once, and commits each agent's finished
episodes into ITS replay.

Lanes are env-major as in the env module: V = E * A lanes ordered
[env0-agent0, env0-agent1, env1-agent0, ...] (envs/predator_prey.py);
the per-agent in-progress buffers are [L1, E, ...] time-major like the
single-learner collector's. All agents share dim_action (the env's joint
action); observation masks, bounds and policy families may differ per
agent. `rollout_chunk` is a Python loop over `one_step` that reads no
device value back; its logs stay on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

from smarties_tpu_torch.models.net import tree_map
from smarties_tpu_torch.replay.buffer import ReplayState, commit_episodes
from smarties_tpu_torch.replay.collector import InProgress, _reset_lanes

F32 = torch.float32
I32 = torch.int32


class MultiRolloutCarry(NamedTuple):
    replays: Tuple[ReplayState, ...]   # one per agent / learner
    inprogs: Tuple[InProgress, ...]    # one per agent, [L1, E, ...]
    env_state: object
    act_gens: Tuple[torch.Generator, ...]   # acting noise, one per agent
    reset_gen: torch.Generator              # env resets
    rnns: Tuple = ()                   # per-agent acting carries


def make_multi_rollout_chunk(env_module, mdps: Sequence,
                             act_fns: Sequence[Callable], max_tot_obs: int,
                             filter_algo: str = "oldest"):
    """Build `rollout_chunk(params_tuple, carry, n_steps) -> (carry,
    logs)`: params_tuple holds one param tree per learner; logs are
    (done [k, E, A], length [k, E, A], ret [k, E, A]) on the device, for
    the host's per-agent reward writer."""
    A = len(mdps)
    assert len(act_fns) == A
    assert all(m.dim_action == mdps[0].dim_action for m in mdps), \
        "joint env action requires equal dim_action across agents"

    def one_step(params_tuple, carry: MultiRolloutCarry):
        rs_t, ip_t, es, gens, gen_reset, rnn_t = carry
        E = ip_t[0].t.shape[0]
        L1 = ip_t[0].states.shape[0]
        lane = torch.arange(E, device=ip_t[0].t.device)

        obs_env = env_module.observe(es).reshape(E, A, -1)

        # act per agent with its own learner
        acts_env, tcurs, new_rnn = [], [], []
        for a in range(A):
            ip, rs = ip_t[a], rs_t[a]
            obs = mdps[a].observed(obs_env[:, a])
            tcur = ip.t.long()
            ip.states[tcur, lane] = obs.to(ip.states.dtype)
            obs_std = (obs - rs.state_mean) * rs.state_scale
            act, mu, val, adv, rnn = act_fns[a](params_tuple[a], obs_std,
                                                gens[a], rnn_t[a])
            ip.actions[tcur, lane] = act
            ip.mus[tcur, lane] = mu
            ip.value[tcur, lane] = val
            ip.advantage[tcur, lane] = adv
            acts_env.append(mdps[a].learner_to_env_action(act))
            tcurs.append(tcur)
            new_rnn.append(rnn)

        env_act = torch.stack(acts_env, dim=1).reshape(E * A, -1)
        es2, reward_v, done_v, terminal_v = env_module.step(es, env_act)
        reward = reward_v.reshape(E, A)
        done = done_v.reshape(E, A)
        terminal = terminal_v.reshape(E, A)
        obs2_env = env_module.observe(es2).reshape(E, A, -1)

        # per-agent episode bookkeeping and commit
        new_rs, new_ip, logs_done, logs_len, logs_ret = [], [], [], [], []
        tgrid = torch.arange(L1, device=lane.device)[None, :]
        for a in range(A):
            ip = ip_t[a]
            tnew = tcurs[a] + 1
            done_a = done[:, a] | (tnew >= L1 - 1)
            ip.rewards[tnew, lane] = reward[:, a]
            # in place, as the collector's; the logs keep the values from
            # before the finished lanes are reset
            t_log, ret_log = tnew.to(I32), ip.cum_reward + reward[:, a]
            ip.t.copy_(t_log)
            ip.cum_reward.copy_(ret_log)
            obs2 = mdps[a].observed(obs2_env[:, a])
            ip.states[tnew, lane] = torch.where(done_a[:, None],
                                                obs2.to(ip.states.dtype),
                                                ip.states[tnew, lane])
            rho_ep = (tgrid < tnew[:, None]).to(F32)
            rs = commit_episodes(
                rs_t[a], ip.states.transpose(0, 1),
                ip.actions.transpose(0, 1), ip.mus.transpose(0, 1),
                ip.rewards.t(), ip.value.t(), ip.advantage.t(),
                torch.zeros_like(rho_ep), rho_ep, ip.t, terminal[:, a],
                done_a, max_tot_obs, filter_algo)
            logs_done.append(done_a)
            logs_len.append(t_log)
            logs_ret.append(ret_log)
            new_ip.append(_reset_lanes(ip, done_a))
            new_rs.append(rs)
            new_rnn[a] = tree_map(lambda h: torch.where(
                done_a.view((-1,) + (1,) * (h.dim() - 1)),
                torch.zeros_like(h), h), new_rnn[a])

        es2 = env_module.reset_where(es2, done_v, gen_reset)
        log = (torch.stack(logs_done, -1), torch.stack(logs_len, -1),
               torch.stack(logs_ret, -1))
        return MultiRolloutCarry(tuple(new_rs), tuple(new_ip), es2, gens,
                                 gen_reset, tuple(new_rnn)), log

    def rollout_chunk(params_tuple, carry: MultiRolloutCarry, n_steps: int):
        logs = []
        for _ in range(n_steps):
            carry, log = one_step(params_tuple, carry)
            logs.append(log)
        return carry, tuple(torch.stack(x) for x in zip(*logs))

    return rollout_chunk

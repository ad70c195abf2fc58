"""Host-side training loop for COMPETING agents: one learner per agent, one
shared env.

Port of smarties_tpu/runtime/multitrainer.py, the multi-learner analog of
runtime/trainer.py. The reference trains per-agent policies with one
learner per MDP descriptor, each agent's data routed to its own learner
and replay (Core/Environment.h:84-97, Core/Worker.cpp:144-188; the demo
apps/predator_prey trains predator and prey as separate policies). Here
each agent owns (params, opt_state, ReplayState); acting and env
stepping run in one rollout chunk (replay/multi_collector.py), followed
by one at-ingest return sweep per learner (K1), and each learner's grad
steps run under its own obsPerStep pacing against the shared env-step
counter, in chunks through the Trainer's `train_chunk`.

As in the port's Trainer, pacing reads host counters only and the
episode logs stay on the device until they are written (every 32 rolls,
and before avg_return, evaluate and save); warmup reads the stored-step
count back once per chunk, as the JAX package's does. Random streams are
torch.Generators seeded from cfg.randSeed: env resets, evaluation starts,
and per learner its initial weights (on the CPU), acting noise and
minibatches. `save` writes torch.save of CPU tensors (.pt) where the JAX
package pickles.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import tree_map
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.replay.collector import init_inprogress
from smarties_tpu_torch.replay.multi_collector import (MultiRolloutCarry,
                                                       make_multi_rollout_chunk)
from smarties_tpu_torch.runtime.trainer import (_plain, _restructure,
                                                _seeds, checked_device,
                                                set_precision, train_chunk)


class MultiTrainer:
    def __init__(self, env_module, mdps: Sequence[MDPSpec], cfgs,
                 n_envs: int = 32, n_slots: Optional[int] = None,
                 max_len: int = 512, run_dir: Optional[str] = None,
                 train_mask: Optional[Sequence[bool]] = None, *, device):
        """n_envs: env INSTANCES (each with len(mdps) agent lanes).
        cfgs: one HyperParameters shared, or a list (one per learner).
        train_mask: per-learner flag; False freezes that learner's
        parameters (it still acts with exploration), for alternating
        training of competing agents. device: required, as the
        Trainer's."""
        from smarties_tpu_torch.algos.registry import make_learner
        A = len(mdps)
        self.A = A
        self.env = env_module
        self.mdps = list(mdps)
        self.cfgs = (list(cfgs) if isinstance(cfgs, (list, tuple))
                     else [cfgs] * A)
        self.algos = [make_learner(m, c)
                      for m, c in zip(self.mdps, self.cfgs)]
        for c in self.cfgs:
            c.check()
        set_precision()
        self.device = checked_device(device)
        self.n_envs = n_envs
        self.max_len = max_len
        self.run_dir = run_dir
        self.train_mask = (list(train_mask) if train_mask is not None
                           else [True] * A)
        self._rew_files = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._rew_files = [open(os.path.join(
                run_dir, f"agent_{a:02d}_rank00_cumulative_rewards.dat"),
                "a") for a in range(A)]

        cfg0 = self.cfgs[0]
        n_slots = n_slots or max(256, 2 * cfg0.maxTotObsNum // max(
            8, max_len // 8))
        self.n_slots = n_slots

        seeds = _seeds(cfg0.randSeed, 2 + 3 * A)

        def dev_gen(s):
            return torch.Generator(device=self.device).manual_seed(s)

        self.gen_env, self.gen_eval = dev_gen(seeds[0]), dev_gen(seeds[1])
        self.gen_act = [dev_gen(seeds[2 + 3 * a + 1]) for a in range(A)]
        self.gen_batch = [dev_gen(seeds[2 + 3 * a + 2]) for a in range(A)]
        self.params: List = []
        self.opt_states: List = []
        replays, inprogs, rnns = [], [], []
        for a, algo in enumerate(self.algos):
            p, o = algo.init(torch.Generator().manual_seed(seeds[2 + 3 * a]),
                             self.device)
            self.params.append(p)
            self.opt_states.append(o)
            m = self.mdps[a]
            replays.append(rb.init_replay(
                n_slots, max_len, m.dim_state_observed, m.dim_action,
                m.dim_policy, self.cfgs[a].clipImpWeight,
                mu_init=rb.safe_mu(m), device=self.device))
            inprogs.append(init_inprogress(
                n_envs, max_len, m.dim_state_observed, m.dim_action,
                m.dim_policy, device=self.device))
            rnns.append(self._init_rnn(a, n_envs))
        env_state = env_module.init(self.gen_env, n_envs * A, self.device)
        self.carry = MultiRolloutCarry(tuple(replays), tuple(inprogs),
                                       env_state, tuple(self.gen_act),
                                       self.gen_env, tuple(rnns))

        act_fns = [algo.make_act_fn(train=c.bTrain)
                   for algo, c in zip(self.algos, self.cfgs)]
        self._rollout = make_multi_rollout_chunk(
            env_module, self.mdps, act_fns, cfg0.maxTotObsNum,
            cfg0.ERoldSeqFilter)
        # the three return-sweep callables per learner (K1 runs inside)
        self._fix_returns = [
            (lambda rs, c=c, algo=algo: rb.refresh_new_returns(
                rs, c.gamma, c.lambda_, algo.returns_mode))
            for c, algo in zip(self.cfgs, self.algos)]
        self._refresh = [algo.refresh for algo in self.algos]
        self._init_stats = [algo.initialize_stats for algo in self.algos]

        self.n_env_steps = 0          # per-lane steps (same for all agents)
        self.n_grad_steps = [0] * A
        self._initialized = [False] * A
        self._start_env_steps = 0
        self._last_refresh = [0] * A
        self._ep_returns = [[] for _ in range(A)]
        self.log_flush_threshold = 32
        self._pending_logs = []       # device-side logs awaiting transfer

    # ------------------------------------------------------------------
    def _init_rnn(self, a: int, n: int) -> tuple:
        algo = self.algos[a]
        return (algo.init_rnn(n, self.device) if hasattr(algo, "init_rnn")
                else ())

    def _set_replay(self, a: int, rs: rb.ReplayState):
        self.carry = self.carry._replace(replays=tuple(
            rs if i == a else r for i, r in enumerate(self.carry.replays)))

    def _roll(self, n_steps: int):
        self.carry, logs = self._rollout(tuple(self.params), self.carry,
                                         n_steps)
        for a in range(self.A):
            self._set_replay(a, self._fix_returns[a](self.carry.replays[a]))
        self.n_env_steps += n_steps * self.n_envs
        # deferred transfer; the counters of the roll go with its rows
        self._pending_logs.append((logs, list(self.n_grad_steps),
                                   self.n_env_steps))
        if len(self._pending_logs) >= self.log_flush_threshold:
            self._flush_logs()

    def _flush_logs(self):
        pending, self._pending_logs = self._pending_logs, []
        for logs, g, e in pending:
            self._log_episodes(logs, g, e)

    def _log_episodes(self, logs, g, e):
        done, length, ret = (x.cpu().numpy() for x in logs)   # [k, E, A]
        for a in range(self.A):
            d = done[..., a]
            if not d.any():
                continue
            ls, rs_ = length[..., a][d], ret[..., a][d]
            self._ep_returns[a].extend(map(float, rs_))
            self._ep_returns[a] = self._ep_returns[a][-500:]
            if self._rew_files:
                # [grad-step, env-step, agentID, ep-length, return]
                for l, r in zip(ls, rs_):
                    self._rew_files[a].write(f"{g[a]} {e} {a} {l} {r}\n")

    # ------------------------------------------------------------------
    def warmup(self, chunk: int = 16):
        """Roll until the first learner's replay holds minTotObsNum
        observations (one read of its stored-step count per chunk), then
        each learner's initialize_stats."""
        cfg0 = self.cfgs[0]
        while int(self.carry.replays[0].n_stored_steps()) \
                < cfg0.minTotObsNum:
            self._roll(chunk)
        for a in range(self.A):
            self._set_replay(a, self._init_stats[a](self.carry.replays[a]))
        self._initialized = [True] * self.A
        self._start_env_steps = self.n_env_steps

    # ------------------------------------------------------------------
    def _allowed(self, a: int) -> int:
        return int((self.n_env_steps - self._start_env_steps)
                   / self.cfgs[a].obsPerStep)

    def train(self, n_grad_steps: int, max_wall_s: float = float("inf")):
        """Each learner of train_mask takes n_grad_steps more gradient
        steps, in chunks of up to Q = 50, paced by ITS obsPerStep against
        the shared env-step counter; 8 env sweeps whenever a learner may
        not step; each learner's refresh every 1000 of its steps."""
        if not all(self._initialized):
            self.warmup()
        A = self.A
        targets = [g + n_grad_steps if self.train_mask[a] else g
                   for a, g in enumerate(self.n_grad_steps)]
        t0 = time.time()
        Q = 50
        while (any(self.n_grad_steps[a] < targets[a] for a in range(A))
               and time.time() - t0 < max_wall_s):
            progressed = False
            for a in range(A):
                if not self.train_mask[a]:
                    continue
                n_tr = min(Q, self._allowed(a) - self.n_grad_steps[a],
                           targets[a] - self.n_grad_steps[a])
                if n_tr <= 0:
                    continue
                progressed = True
                self.params[a], self.opt_states[a], rs, _ = train_chunk(
                    self.algos[a], self.cfgs[a], self.params[a],
                    self.opt_states[a], self.carry.replays[a],
                    self.gen_batch[a], n_tr)
                self._set_replay(a, rs)
                self.n_grad_steps[a] += n_tr
                if self.n_grad_steps[a] // 1000 \
                        > self._last_refresh[a] // 1000:
                    self._last_refresh[a] = self.n_grad_steps[a]
                    self._set_replay(a, self._refresh[a](
                        self.carry.replays[a], float(self.n_grad_steps[a])))
            if not progressed or any(
                    self.n_grad_steps[a] < targets[a]
                    and self._allowed(a) <= self.n_grad_steps[a]
                    for a in range(A) if self.train_mask[a]):
                self._roll(8)
        self._flush_logs()

    # ------------------------------------------------------------------
    def avg_return(self, a: int, last: int = 100) -> float:
        self._flush_logs()
        r = self._ep_returns[a][-last:]
        return float(np.mean(r)) if r else float("nan")

    @torch.no_grad()
    def evaluate(self, n_episodes: int = 16, max_steps: int = 250
                 ) -> np.ndarray:
        """Deterministic joint evaluation -> returns [n_episodes, A]. Start
        states come from the evaluation's own generator (`gen_eval`), so
        an evaluation leaves the training resets' stream alone."""
        env, mdps, A = self.env, self.mdps, self.A
        self._flush_logs()
        act_fns = [algo.make_act_fn(False) for algo in self.algos]
        rnns = [self._init_rnn(a, n_episodes) for a in range(A)]
        es = env.init(self.gen_eval, n_episodes * A, self.device)
        rets = torch.zeros((n_episodes, A), device=self.device)
        done = torch.zeros((n_episodes,), dtype=torch.bool,
                           device=self.device)
        for _ in range(max_steps):
            obs_env = env.observe(es).reshape(n_episodes, A, -1)
            acts = []
            for a in range(A):
                rs = self.carry.replays[a]
                obs = (mdps[a].observed(obs_env[:, a]) - rs.state_mean) \
                    * rs.state_scale
                act, _, _, _, rnns[a] = act_fns[a](self.params[a], obs,
                                                   self.gen_eval, rnns[a])
                acts.append(mdps[a].learner_to_env_action(act))
            env_act = torch.stack(acts, 1).reshape(n_episodes * A, -1)
            es, r, d, _ = env.step(es, env_act)
            rets = rets + r.reshape(n_episodes, A) * (~done).to(
                r.dtype)[:, None]
            done = done | d.reshape(n_episodes, A).any(-1)
        out = rets.cpu().numpy()
        if not np.isfinite(out).all():
            raise FloatingPointError("non-finite returns during "
                                     "evaluation — training diverged")
        return out

    # ------------------------------------------------------------------
    def state(self) -> dict:
        """Every learner's params, optimiser state, replay fields and
        grad-step count, and the shared counters, as CPU tensors (named
        tuples as dicts): what `save` writes and `load` takes."""
        cpu = lambda x: x.detach().cpu()
        return {"learners": [
            {"params": tree_map(cpu, self.params[a]),
             "opt_state": tree_map(cpu, _plain(self.opt_states[a])),
             "replay": {f: cpu(getattr(self.carry.replays[a], f))
                        for f in self.carry.replays[a].__dataclass_fields__},
             "n_grad_steps": self.n_grad_steps[a]}
            for a in range(self.A)],
            "n_env_steps": self.n_env_steps,
            "start_env_steps": self._start_env_steps,
            "initialized": list(self._initialized)}

    def load(self, state: dict):
        """Set every learner's params, optimiser state, replay and
        counters from `state` (the form of `state()`; from a JAX
        MultiTrainer through convert.multitrainer_from_jax)."""
        dev = self.device
        for a, ls in enumerate(state["learners"]):
            with torch.no_grad():
                tree_map(lambda dst, src: dst.copy_(src), self.params[a],
                         ls["params"])
            self.opt_states[a] = _restructure(
                self.opt_states[a],
                tree_map(lambda x: x.to(dev), ls["opt_state"]))
            self._set_replay(a, rb.ReplayState(**{
                f: v.to(dev).clone() for f, v in ls["replay"].items()}))
            self.n_grad_steps[a] = int(ls["n_grad_steps"])
        self.n_env_steps = int(state["n_env_steps"])
        self._start_env_steps = int(state.get("start_env_steps",
                                              self.n_env_steps))
        self._initialized = [bool(x) for x in state["initialized"]]

    def save(self, path: str):
        """torch.save of `state()` (loadable with weights_only=True), and
        flush the reward files."""
        self._flush_logs()
        for f in self._rew_files or ():
            f.flush()
        tmp = path + ".tmp"
        torch.save(self.state(), tmp)
        os.replace(tmp, path)

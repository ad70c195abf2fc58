"""Host-side training driver: pacing, warmup, eval, logging, checkpointing.

Port of the single-device path of smarties_tpu/runtime/trainer.py
(reference runtime: Core/Worker.cpp:53-142 runTraining,
Learner::blockDataAcquisition / blockGradientUpdates, Learner.cpp:102-123).
The host loop alternates rollout chunks over all vectorized envs with
chunks of gradient steps, paced by the obsPerStep invariant, or runs the
fused cycle (one env sweep, the at-ingest Retrace sweep, n_envs /
obsPerStep gradient steps). An on-policy learner (PPO) runs the horizon
cycle instead (PPO.cpp:44-115): fill the horizon with fresh data, its
epochs of minibatch updates, one statistics refresh, clear the replay.
That loop reads the stored-step count back once per rollout chunk, as
the JAX package's does; it is outside any fused cycle.

PyTorch runs eagerly: a "program" of the JAX package is a Python loop
issuing CUDA kernels on the current stream. Pacing reads only host
counters; no cycle reads a device value back (no .item(), .cpu() or
bool(tensor) in one_step, train_step, the ingest sweep or the refresh),
so the host runs ahead of the card and a later CUDA-graph capture stays
possible. Logs and metrics stay on the device until log time.

Randomness comes from explicit torch.Generators on the device: one for
env resets (and evaluation starts), one for acting noise, one for
minibatch draws; parameters are initialised from a CPU generator so
that they do not depend on the device. All three derive from
cfg.randSeed.

Left out of the JAX trainer: the device mesh, the TPU-worker crash
retry of train_fused, SMT_PACK_STATES, the phase profiler, and the raw
observation and gradient-moment dumps. On a CUDA device a host timer
around a phase measures only its enqueue; time with CUDA events or
torch.profiler instead.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from smarties_tpu_torch.algos.base import presample_uniform
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import tree_map
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.replay.collector import (InProgress, RolloutCarry,
                                                 RolloutGens,
                                                 init_inprogress,
                                                 make_rollout_chunk)
from smarties_tpu_torch.utils.config import HyperParameters


def _seeds(seed: int, n: int):
    """n independent 63-bit seeds derived from one integer seed."""
    return [int(s.generate_state(2, np.uint64)[0] >> np.uint64(1))
            for s in np.random.SeedSequence(seed).spawn(n)]


def _plain(tree):
    """Named tuples -> dicts, tuples -> lists, recursively: what
    torch.load(weights_only=True) reads back."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return tree


def _restructure(template, plain):
    """Inverse of _plain, shaped like `template`."""
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(**{k: _restructure(getattr(template, k),
                                                 plain[k])
                                 for k in template._fields})
    if isinstance(template, dict):
        return {k: _restructure(v, plain[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restructure(t, p)
                              for t, p in zip(template, plain, strict=True))
    return plain


class Trainer:
    def __init__(self, env_module, mdp: MDPSpec, cfg: HyperParameters,
                 n_envs: int = 64, n_slots: Optional[int] = None,
                 max_len: int = 512, *, device, run_dir: Optional[str] = None,
                 algo_cls=None, state_dtype=None):
        """device: where every tensor lives ("cuda", "cuda:1", "cpu"). It
        is required: nothing picks the CPU when a card is missing.
        state_dtype: storage type of the raw states in the replay and the
        in-progress episodes (default f32; torch.uint8 for pixels)."""
        if device is None:
            raise ValueError("Trainer needs an explicit device")
        # the learner first: one the port lacks is reported before any
        # settings check
        if algo_cls is None:
            from smarties_tpu_torch.algos.registry import make_learner
            self.algo = make_learner(mdp, cfg)
        else:
            self.algo = algo_cls(mdp, cfg)
        cfg.check()
        if cfg.nnBf16:
            raise NotImplementedError("nnBf16: the port computes in f32")
        # f32 throughout: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.env = env_module
        self.mdp = mdp
        self.cfg = cfg
        self.n_envs = n_envs
        self.max_len = max_len
        n_slots = n_slots or max(256, 2 * cfg.maxTotObsNum // max(
            8, max_len // 8))
        self.n_slots = n_slots
        if n_envs > n_slots:
            raise ValueError(f"n_envs {n_envs} > n_slots {n_slots}")
        self.run_dir = run_dir
        self._rew_file = None
        if run_dir:
            os.makedirs(run_dir, exist_ok=True)
            self._rew_file = open(os.path.join(
                run_dir, "agent_00_rank00_cumulative_rewards.dat"), "a")

        s_init, s_env, s_act, s_batch = _seeds(cfg.randSeed, 4)
        self.params, self.opt_state = self.algo.init(
            torch.Generator().manual_seed(s_init), self.device)

        def dev_gen(s):
            return torch.Generator(device=self.device).manual_seed(s)

        self.gen_env, self.gen_act, self.gen_batch = (
            dev_gen(s_env), dev_gen(s_act), dev_gen(s_batch))

        sdt = state_dtype or torch.float32
        rs = rb.init_replay(n_slots, max_len, mdp.dim_state_observed,
                            mdp.dim_action, mdp.dim_policy,
                            cfg.clipImpWeight, mu_init=rb.safe_mu(mdp),
                            device=self.device, state_dtype=sdt)
        ip = init_inprogress(n_envs, max_len, mdp.dim_state_observed,
                             mdp.dim_action, mdp.dim_policy,
                             device=self.device, state_dtype=sdt)
        env_state = env_module.init(self.gen_env, n_envs, self.device)
        self.carry = RolloutCarry(rs, ip, env_state,
                                  RolloutGens(self.gen_act, self.gen_env),
                                  self._init_rnn(n_envs))

        act_fn = self.algo.make_act_fn(train=cfg.bTrain)
        # on-policy (PPO) fills a horizon, then clears: the commit cap gets
        # slack so that commit-time pruning never drops fresh horizon data
        self.on_policy = self.algo.on_policy
        commit_cap = cfg.maxTotObsNum * (4 if self.on_policy else 1)
        self._rollout = make_rollout_chunk(
            env_module, mdp, act_fn, commit_cap, cfg.ERoldSeqFilter)
        mode = self.algo.returns_mode
        # the three return-sweep callables (K1 runs inside each)
        self._fix_returns = lambda r: rb.refresh_new_returns(
            r, cfg.gamma, cfg.lambda_, mode)
        self._refresh = self.algo.refresh
        self._init_stats = self.algo.initialize_stats

        self.n_env_steps = 0          # nSeenTransitions_loc
        self.n_grad_steps = 0
        # nObsB4StartTraining; an on-policy learner starts at a full
        # horizon, which its settings may leave below minTotObsNum
        self.n_obs_b4_start = (min(cfg.minTotObsNum, cfg.maxTotObsNum)
                               if self.on_policy else cfg.minTotObsNum)
        self.log_flush_threshold = 32
        self._initialized = False
        self._min_stored_reached = False
        self._last_refresh = 0
        self._last_log = 0
        self._last_save = 0
        self._last_metrics = {}
        self._ep_returns = []         # recent completed-episode returns
        self._pending_logs = []       # device-side logs awaiting transfer

    # ------------------------------------------------------------------
    @property
    def replay(self) -> rb.ReplayState:
        return self.carry.replay

    @property
    def algo_is_recurrent(self) -> bool:
        return self.cfg.nnType in ("LSTM", "GRU", "RNN")

    def _init_rnn(self, n: int) -> tuple:
        """The learner's zero acting carry for n lanes (the recurrent
        state of its net, after the OU state for NAF and DPG), () if it
        has none."""
        if hasattr(self.algo, "init_rnn"):
            return self.algo.init_rnn(n, self.device)
        return ()

    def _roll(self, n_steps: int):
        self.carry, logs = self._rollout(self.params, self.carry, n_steps)
        # at-ingest Retrace for the episodes committed in the chunk
        self.carry = self.carry._replace(
            replay=self._fix_returns(self.carry.replay))
        self.n_env_steps += n_steps * self.n_envs
        # deferred transfer; counters captured now so the rows keep the
        # grad/env-step columns of their episodes (MemoryBuffer.cpp:491)
        self._pending_logs.append((logs, self.n_grad_steps,
                                   self.n_env_steps))
        if len(self._pending_logs) >= self.log_flush_threshold:
            self._flush_logs()

    def _flush_logs(self):
        pending, self._pending_logs = self._pending_logs, []
        for logs, g, e in pending:
            self._log_episodes(logs, g, e)

    def _log_episodes(self, logs, g=None, e=None):
        g = self.n_grad_steps if g is None else g
        e = self.n_env_steps if e is None else e
        done, length, ret = (x.cpu().numpy() for x in logs[:3])
        if not done.any():
            return
        agent = np.nonzero(done)[1]
        for a, l, r in zip(agent, length[done], ret[done]):
            self._ep_returns.append(float(r))
            if self._rew_file:
                # [grad-step, env-step, agentID, ep-length, return]
                # byte-format of MemoryBuffer.cpp:491-513
                self._rew_file.write(f"{g} {e} {a} {l} {r}\n")
        if len(self._ep_returns) > 1000:
            self._ep_returns = self._ep_returns[-1000:]

    # ------------------------------------------------------------------
    def warmup(self, chunk: int = 64, adaptive: bool = True,
               blind_sweeps: Optional[int] = None):
        """Gather minTotObsNum observations before training (stepInit,
        RACER.cpp:69-77), then initialize_stats.

        adaptive: shrink the last chunk to one sweep so long episodes do
        not overshoot the start threshold by a whole chunk.
        blind_sweeps: run exactly this many env sweeps without reading
        the stored-step counter back (no host synchronisation); the
        caller guarantees that they cover minTotObsNum."""
        if blind_sweeps is not None:
            done = 0
            while done < blind_sweeps:
                self._roll(chunk)
                done += chunk
        else:
            while int(self.replay.n_stored_steps()) < self.n_obs_b4_start:
                in_flight = int(torch.sum(self.carry.inprog.t))
                remaining = (self.n_obs_b4_start
                             - int(self.replay.n_stored_steps()) - in_flight)
                n = max(1, min(chunk, int(np.ceil(
                    max(remaining, self.n_envs) / self.n_envs))))
                n = chunk if (n >= chunk or not adaptive) else 1
                self._roll(n)
        self.carry = self.carry._replace(
            replay=self._init_stats(self.carry.replay))
        self._initialized = True

    # ------------------------------------------------------------------
    def _n_loc_train_steps(self) -> int:
        return self.n_env_steps - self.n_obs_b4_start

    def block_data(self) -> bool:
        """Learner::blockDataAcquisition (Learner.cpp:102-113). The
        one-time start condition reads the stored-step count back until
        it holds, then is cached."""
        if not self._min_stored_reached:
            if int(self.replay.n_stored_steps()) < self.n_obs_b4_start:
                return False
            self._min_stored_reached = True
        return (self._n_loc_train_steps()
                > (self.n_grad_steps + 1) * self.cfg.obsPerStep)

    def block_grads(self) -> bool:
        """Learner::blockGradientUpdates (Learner.cpp:115-123)."""
        return (self._n_loc_train_steps()
                < self.n_grad_steps * self.cfg.obsPerStep)

    # ------------------------------------------------------------------
    @property
    def _can_presample(self) -> bool:
        """Uniform indices can be drawn for a whole chunk up front; the
        prioritized samplers depend on the TD errors each step writes and
        draw inside the step."""
        return self.cfg.dataSamplingAlgo in ("uniform", "default")

    def _train_chunk(self, n: int):
        """n gradient steps, on uniform indices drawn up front or on each
        step's own prioritized draw; metrics stacked [n] per key, on the
        device."""
        rs = self.carry.replay
        if self._can_presample:
            eps, ts = presample_uniform(self.gen_batch, rs,
                                        self.cfg.batchSize, n)
        ms = []
        for i in range(n):
            self.params, self.opt_state, rs, m = self.algo.train_step(
                self.params, self.opt_state, rs, gen=self.gen_batch,
                sample_override=((eps[i], ts[i]) if self._can_presample
                                 else None))
            ms.append(m)
        self.carry = self.carry._replace(replay=rs)
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    def _fused_cycle(self, n_roll: int, n_train: int):
        """[n_roll env sweeps + at-ingest returns + n_train grad steps]:
        the JAX package's fused program as one host call. The ingest
        sweep runs K1 here too (the JAX package could not co-compile its
        kernel with lax.scan and used an associative scan instead)."""
        self.carry, logs = self._rollout(self.params, self.carry, n_roll)
        self.carry = self.carry._replace(
            replay=self._fix_returns(self.carry.replay))
        return self._train_chunk(n_train), logs

    def train_fused(self, n_grad_steps: int, log_every: int = 1000,
                    max_wall_s: float = float("inf"), flush: bool = True):
        """Steady-state training with fused cycles: each cycle rolls one
        env sweep (n_envs observations) and runs n_envs/obsPerStep grad
        steps, keeping the obsPerStep invariant exactly. The 1000-step
        refresh runs between cycles at the nearest boundary. An on-policy
        learner has no such cycle and takes train()'s horizon loop; so does
        a prioritized sampler, as in the JAX package, whose fused program
        needs presampled indices."""
        if self.on_policy or not self._can_presample:
            return self.train(n_grad_steps, log_every, max_wall_s)
        if not self._initialized:
            self.warmup()
        n_train = max(1, int(round(self.n_envs / self.cfg.obsPerStep)))
        target = self.n_grad_steps + n_grad_steps
        t0 = time.time()
        while self.n_grad_steps < target and time.time() - t0 < max_wall_s:
            metrics, logs = self._fused_cycle(1, n_train)
            self.n_env_steps += self.n_envs
            self.n_grad_steps += n_train
            self._pending_logs.append((logs, self.n_grad_steps,
                                       self.n_env_steps))
            if len(self._pending_logs) >= self.log_flush_threshold:
                self._flush_logs()
            self._last_metrics = metrics
            if self.cfg.debugNaN:
                self._check_nan()
            if self.n_grad_steps // 1000 > self._last_refresh // 1000:
                self._last_refresh = self.n_grad_steps
                self.carry = self.carry._replace(
                    replay=self._refresh(self.carry.replay,
                                         float(self.n_grad_steps)))
            if (self.n_grad_steps - self._last_log) >= log_every:
                self._last_log = self.n_grad_steps
                self.log_status()
        if flush:
            self._flush_logs()

    # ------------------------------------------------------------------
    def train(self, n_grad_steps: int, log_every: int = 1000,
              max_wall_s: float = float("inf")):
        """Run until n_grad_steps more gradient steps are done, in train
        chunks of Q = 100 (a divisor of the refresh cadence) and rollout
        chunks, paced by the obsPerStep invariant. On-policy learners
        run the horizon cycle, with no warmup."""
        if self.on_policy:
            return self._train_on_policy(n_grad_steps, log_every,
                                         max_wall_s)
        if not self._initialized:
            self.warmup()
        target = self.n_grad_steps + n_grad_steps
        t0 = time.time()
        Q = 100
        while self.n_grad_steps < target and time.time() - t0 < max_wall_s:
            allowed = int(self._n_loc_train_steps() / self.cfg.obsPerStep
                          ) - self.n_grad_steps
            allowed = min(allowed, target - self.n_grad_steps)
            n_tr = Q if allowed >= Q else max(0, allowed)
            if n_tr > 0:
                self._last_metrics = self._train_chunk(n_tr)
                self.n_grad_steps += n_tr
                if self.cfg.debugNaN:
                    self._check_nan()
            if self.n_grad_steps // 1000 > self._last_refresh // 1000:
                self._last_refresh = self.n_grad_steps
                self.carry = self.carry._replace(
                    replay=self._refresh(self.carry.replay,
                                         float(self.n_grad_steps)))
            if not self.block_data():
                roll_n = max(1, min(64, int(np.ceil(
                    Q * self.cfg.obsPerStep / self.n_envs))))
                self._roll(roll_n)
            if (self.n_grad_steps - self._last_log) >= log_every:
                self._last_log = self.n_grad_steps
                self.log_status()
            # periodic checkpoint (saveFreq, Learner.cpp:146)
            if (self.run_dir and self.n_grad_steps // self.cfg.saveFreq
                    > self._last_save // self.cfg.saveFreq):
                self._last_save = self.n_grad_steps
                self.save(os.path.join(self.run_dir, "checkpoint.pt"))
        self._flush_logs()

    # ------------------------------------------------------------------
    def _train_on_policy(self, n_grad_steps: int, log_every: int = 1000,
                         max_wall_s: float = float("inf")):
        """PPO's horizon cycle (PPO.cpp:44-115): fill nHorizon fresh
        transitions, nEpochs of minibatch updates over them (in chunks of
        one data pass), the reward/state statistics refreshed once, then
        the replay cleared; repeated until n_grad_steps more steps are
        done (whole cycles: the last one may overshoot)."""
        algo = self.algo
        horizon = algo.n_horizon
        updates_per_cycle = algo.n_epochs * horizon // self.cfg.batchSize
        per_epoch = max(1, horizon // self.cfg.batchSize)
        roll_n = max(1, min(64, (horizon // 8) // self.n_envs or 1))
        target = self.n_grad_steps + n_grad_steps
        t0 = time.time()
        while self.n_grad_steps < target and time.time() - t0 < max_wall_s:
            # fill the horizon with fresh on-policy data: one read of the
            # stored-step count per rollout chunk
            while int(self.replay.n_stored_steps()) < horizon:
                self._roll(roll_n)
            if not self._initialized:
                self.carry = self.carry._replace(
                    replay=self._init_stats(self.carry.replay))
                self._initialized = True
            done_in_cycle = 0
            while done_in_cycle < updates_per_cycle:
                n_tr = min(per_epoch, updates_per_cycle - done_in_cycle)
                self._last_metrics = self._train_chunk(n_tr)
                self.n_grad_steps += n_tr
                done_in_cycle += n_tr
                if self.cfg.debugNaN:
                    self._check_nan()
            # once per data pass: reward/state stats (PPO.cpp:100-104)
            self.carry = self.carry._replace(
                replay=self._refresh(self.carry.replay,
                                     float(self.n_grad_steps)))
            if (self.n_grad_steps - self._last_log) >= log_every:
                self._last_log = self.n_grad_steps
                self.log_status()
            # epoch over: discard the data (PPO.cpp:105-112)
            self.carry = self.carry._replace(
                replay=rb.clear_all(self.carry.replay))
        self._flush_logs()

    # ------------------------------------------------------------------
    def _check_nan(self):
        """Raise on non-finite training metrics (Agent::checkNanOrInf,
        Agent.h:301-313). Reads the metrics back: a synchronisation."""
        for k in ("rmse", "grad_norm", "beta"):
            if k in self._last_metrics and not bool(
                    torch.isfinite(self._last_metrics[k]).all()):
                raise FloatingPointError(
                    f"non-finite training metric '{k}' at grad step "
                    f"{self.n_grad_steps} — training diverged")

    def log_status(self):
        self._flush_logs()
        self._check_nan()
        rs = self.replay
        avg_r = (np.mean(self._ep_returns[-100:])
                 if self._ep_returns else float("nan"))
        m = self._last_metrics
        get = lambda k: float(m[k][-1]) if k in m else float("nan")
        print(f"step {self.n_grad_steps:>8d} | envstep {self.n_env_steps:>9d}"
              f" | avgR {avg_r:8.2f} | beta {float(rs.beta):.3f}"
              f" | dkl {get('avg_dkl'):.4f} | rmse {get('rmse'):.3f}"
              f" | nEp {int(rs.n_stored_eps())}"
              f" | nObs {int(rs.n_stored_steps())}", flush=True)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, n_episodes: int = 10, max_steps: int = 1000,
                 materialize: bool = True):
        """Deterministic-policy evaluation episodes (bTrain=0 serving path,
        Worker.cpp:91-111). Start states come from the env generator.

        materialize=False returns the device tensor of returns without
        reading it back (the caller checks it)."""
        act = self.algo.make_act_fn(False)
        env, mdp = self.env, self.mdp
        rs = self.replay
        es = env.init(self.gen_env, n_episodes, self.device)
        rets = torch.zeros((n_episodes,), dtype=torch.float32,
                           device=self.device)
        done = torch.zeros((n_episodes,), dtype=torch.bool,
                           device=self.device)
        rnn = self._init_rnn(n_episodes)
        # frame history, newest first, tiled from the first observation
        k_app = mdp.n_appended_obs
        hist = mdp.observed(env.observe(es))[:, None, :].repeat(
            1, k_app + 1, 1)
        for _ in range(max_steps):
            obs = mdp.observed(env.observe(es))
            hist = torch.cat([obs[:, None, :], hist[:, :k_app]], dim=1)
            obs_std = ((hist - rs.state_mean) * rs.state_scale
                       ).reshape(n_episodes, -1)
            a, _, _, _, rnn = act(self.params, obs_std, self.gen_act, rnn)
            es, r, d, _ = env.step(es, mdp.learner_to_env_action(a))
            rets = rets + r * (~done).to(r.dtype)
            done = done | d
        if not materialize:
            return rets
        out = rets.cpu().numpy()
        # NaN guard (Agent::checkNanOrInf, Agent.h:301-313)
        if not np.isfinite(out).all():
            raise FloatingPointError("non-finite returns during "
                                     "evaluation — training diverged")
        return out

    # ------------------------------------------------------------------
    def save(self, path: str):
        """Checkpoint params/opt/replay/rollout state/acting carry/
        generators/counters with torch.save (the fields of the JAX
        package's pickle; the replay in the port's per-field layout), and
        flush cumulative_rewards.dat. Loadable with weights_only=True:
        named tuples are stored as plain dicts and lists."""
        self._flush_logs()
        if self._rew_file:
            self._rew_file.flush()
        ip = self.carry.inprog
        state = {
            "params": tree_map(lambda x: x.detach(), self.params),
            "opt_state": _plain(self.opt_state),
            "replay": {f: getattr(self.carry.replay, f)
                       for f in self.carry.replay.__dataclass_fields__},
            "inprog": ip._asdict(),
            "env_state": self.carry.env_state._asdict(),
            "rnn": _plain(self.carry.rnn),
            "gens": {k: getattr(self, "gen_" + k).get_state()
                     for k in ("env", "act", "batch")},
            "n_env_steps": self.n_env_steps,
            "n_grad_steps": self.n_grad_steps,
            "initialized": self._initialized,
            "cfg": self.cfg.to_dict(),
        }
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)  # write-then-rename atomicity

    def restore(self, path: str):
        """Load a checkpoint of this configuration: the params are copied
        into the existing leaves (nested {"net", "tgt"} trees included),
        the optimiser state and acting carry are rebuilt in the structure
        of the current ones (AdamState, MixedPGOptState, PPOOptState; the
        carry's nested tuples, LSTM (h, c) pairs included)."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), self.params,
                     state["params"])
        self.opt_state = _restructure(self.opt_state, state["opt_state"])
        self.carry = RolloutCarry(
            rb.ReplayState(**state["replay"]),
            InProgress(**state["inprog"]),
            type(self.carry.env_state)(**state["env_state"]),
            self.carry.gens,
            _restructure(self.carry.rnn, state["rnn"]))
        for k, st in state["gens"].items():
            getattr(self, "gen_" + k).set_state(st.cpu())
        self.n_env_steps = state["n_env_steps"]
        self.n_grad_steps = state["n_grad_steps"]
        self._initialized = state["initialized"]

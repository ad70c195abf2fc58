"""Engine: public entry point for external (user-application) envs.

Port of smarties_tpu/runtime/engine.py (reference: source/smarties/
Engine.{h,cpp}, Core/Master.cpp, Core/Worker.cpp): env apps run in
worker processes behind the Communicator API (runtime/communicator.py);
the learner batches all pending agent states into one action-selection
call, assembles episodes on the host, and commits them to the replay on
the device; training interleaves under the obsPerStep pacing invariant
(Learner.cpp:102-123).

The serving loop is the JAX package's, line for line:
- multiple learners per session when the app declares per-agent MDPs
  (Environment.h:84-97; lane -> learners[localID], Worker.cpp:148,188),
  each with its own settings (`setLearnerSettings`, settings_%02u.json);
- per-agent recurrent contexts, advanced only for the lanes served in a
  round (AgentContext, Network/ThreadContext.h:19-100);
- training BEFORE replying, so envs stall while the learner is behind
  (learnersBlockingDataAcquisition, Core/Master.cpp:118-144);
- FAIL status and crashed apps: the episode is dropped and the context
  reset (Agent.h:83-86), the EnvPool respawns the app;
- eval mode (bTrain == 0, --nEvalEpisodes), NaN guards, frame stacking,
  untracked agents, the obs.raw and cumulative_rewards.dat files, and a
  checkpoint every saveFreq grad steps (Learner.cpp:146).

Per round and per learner the host makes one copy of the stacked
observations to the device and one copy of (env action, action, mu,
value, advantage), packed into one tensor, back: the round's only read
of the device. A finished episode goes to the device as one packed copy
and is committed with one launch of K1's `batched_retrace` (on a CUDA
device; its plain version on the CPU) on its [1, max_ep_len + 1] row.
Until the learner starts, the start condition reads the stored-step
count from the device only once a host count of the committed steps
(an upper bound of the stored ones) has reached minTotObsNum.

Checkpoints are `checkpoint.pt` (torch.save of the learners' snapshots,
CPU tensors, loadable with weights_only=True), written to a temporary
name and renamed. The port does not read the JAX package's
checkpoint.pkl: unpickling it needs that package's classes, and so jax
(models/convert.engine_snapshot_from_jax converts its contents).

Usage (README.rst:104-133):

    import smarties_tpu_torch
    def app_main(comm):
        comm.setStateActionDims(6, 1)
        comm.setActionScales([10.], [-10.], True)
        while True:
            comm.sendInitState(env.reset())
            while True:
                act = comm.recvAction()
                ...
                comm.sendState(s, r) / sendTermState / sendLastState

    e = smarties_tpu_torch.Engine(sys.argv)    # on the card; --device cpu
    e.setNEnvironments(8)
    e.run(app_main)
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from smarties_tpu_torch.models.net import tree_leaves, tree_map
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.runtime.communicator import FAIL, INIT, LAST, TERM
from smarties_tpu_torch.runtime.env_pool import EnvPool
from smarties_tpu_torch.runtime.trainer import (_plain, _restructure,
                                                checked_device, set_precision,
                                                train_chunk)
from smarties_tpu_torch.utils.config import HyperParameters


class _EpisodeAssembler:
    """Host-side in-progress episode for one agent lane
    (MemoryBuffer::inProgress analog)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.obs, self.acts, self.mus, self.rewards = [], [], [], []
        self.values, self.advs = [], []

    def add_state(self, obs, reward):
        self.obs.append(obs)
        self.rewards.append(reward)

    def add_action(self, act, mu, value, adv):
        self.acts.append(act)
        self.mus.append(mu)
        self.values.append(value)
        self.advs.append(adv)

    def finalize(self, terminal: bool, max_len: int):
        """-> (padded numpy arrays, length, terminal) for device commit."""
        T = len(self.acts)
        T = min(T, max_len)
        L1 = max_len + 1

        def pad(rows, dim):
            out = np.zeros((L1, dim), np.float32)
            k = min(len(rows), L1)
            if k:
                out[:k] = np.asarray(rows[:k], np.float32).reshape(k, dim)
            return out

        n_obs = len(self.obs[0])
        states = pad(self.obs, n_obs)
        acts = pad(self.acts, len(self.acts[0]) if self.acts else 1)
        mus = pad(self.mus, len(self.mus[0]) if self.mus else 1)
        rewards = np.zeros(L1, np.float32)
        rewards[:min(len(self.rewards), L1)] = self.rewards[:L1]
        value = np.zeros(L1, np.float32)
        value[:min(len(self.values), L1)] = self.values[:L1]
        adv = np.zeros(L1, np.float32)
        adv[:min(len(self.advs), L1)] = self.advs[:L1]
        ret = float(np.sum(self.rewards))
        self.reset()
        return states, acts, mus, rewards, value, adv, T, terminal, ret


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host-to-device copy of a float32 numpy array. To a card it is
    made from page-locked memory and not waited for (the caching host
    allocator keeps the block until the copy is done); on the CPU the
    tensor shares the array."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _LearnerBundle:
    """One learner + its replay + pacing counters — the reference's
    learners vector entry (Worker.cpp:144-186: each incoming agent state
    routes to learners[getLearnerID(localID)]).

    Randomness: the initial weights from a CPU generator (so that they do
    not depend on the device), acting noise and minibatch draws from one
    generator on the device; both seeded from cfg.randSeed and the
    learner id.

    Seams: `sample_indices(n) -> (ep [n, B], t [n, B])`, when set, pins
    the minibatches of every train chunk (a test's injected samples);
    `_train_chunk`, `_refresh`, `_init_stats`, `commit` and `act` are
    looked up on the instance, so a caller can wrap them to count and
    time them."""

    def __init__(self, learner_id: int, mdp, cfg: HyperParameters,
                 lanes: List[int], max_ep_len: int, *, device):
        from smarties_tpu_torch.algos.registry import make_learner
        self.device = checked_device(device)
        set_precision()
        self.learner_id = learner_id
        self.mdp = mdp
        self.cfg = cfg
        self.lanes = list(lanes)
        self.lane_slot = {lane: i for i, lane in enumerate(self.lanes)}
        self.max_ep_len = max_ep_len
        self.algo = make_learner(mdp, cfg)
        self.obs_idx = np.nonzero(mdp.observable_mask)[0]

        seq = np.random.SeedSequence([int(cfg.randSeed), int(learner_id)])
        s_init, s_dev = (int(s.generate_state(2, np.uint64)[0]
                             >> np.uint64(1)) for s in seq.spawn(2))
        self.params, self.opt_state = self.algo.init(
            torch.Generator().manual_seed(s_init), self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(s_dev)
        n_slots = max(64, 2 * cfg.maxTotObsNum // max(8, max_ep_len // 8))
        self.rs = rb.init_replay(n_slots, max_ep_len,
                                 mdp.dim_state_observed, mdp.dim_action,
                                 mdp.dim_policy, cfg.clipImpWeight,
                                 mu_init=rb.safe_mu(mdp), device=self.device)
        # user-provided state box seeds the standardization stats until
        # the online estimates initialize (setStateScales,
        # Communicator.cpp:98-122, StateAction.h:181-203)
        ss = mdp.state_stats_init
        if ss is not None:
            mean, std = (torch.as_tensor(x, device=self.device) for x in ss)
            self.rs.state_mean, self.rs.state_std = mean, std
            self.rs.state_scale = 1.0 / std
        self.act_fn = self.algo.make_act_fn(train=cfg.bTrain)
        # per-agent persistent recurrent context for acting
        # (AgentContext analog); () for feed-forward nets
        self.rnn = (self.algo.init_rnn(len(self.lanes), self.device)
                    if hasattr(self.algo, "init_rnn") else ())
        self._refresh = self.algo.refresh
        self._init_stats = self.algo.initialize_stats
        self.sample_indices: Optional[Callable] = None

        # counters (per-learner, like Learner.h's nGradSteps/nLocTimeSteps)
        self.n_env_steps = 0
        self.n_grad = 0
        self.start_env_steps = 0
        self.initialized = False
        self.last_refresh = 0
        # steps committed so far: >= the stored steps (commits may
        # overwrite or prune), so below minTotObsNum it answers the start
        # condition without reading the device
        self.n_committed_steps = 0

    # ------------------------------------------------------------------
    def reset_rnn_lane(self, lane: int):
        """Zero the recurrent context of one agent lane (AgentContext
        reset at episode start / FAIL), in place."""
        i = self.lane_slot[lane]
        for h in tree_leaves(self.rnn):
            h[i] = 0.0

    def commit(self, ep_arrays, T, terminal):
        """Ingest one finished host-assembled episode
        (MemoryBuffer::terminateCurrentEpisode, :118-170): one packed copy
        to the device, its returns by K1's `batched_retrace` on the
        [1, max_ep_len + 1] row (the plain version on the CPU), then
        `commit_episodes`."""
        from smarties_tpu_torch.ops.returns import batched_return_estimate
        cfg, rs = self.cfg, self.rs
        states, acts, mus, rewards, value, adv = ep_arrays
        L1 = rs.max_len + 1
        fields = (states, acts, mus, rewards, value, adv)
        host = np.concatenate([x.ravel() for x in fields]
                              + [np.asarray([T, terminal], np.float32)])
        parts = torch.split(_to_device(host, self.device),
                            [x.size for x in fields] + [2])
        ep_states, ep_acts, ep_mus = (p.view(1, L1, -1) for p in parts[:3])
        ep_rew, ep_val, ep_adv = (p.view(1, L1) for p in parts[3:6])
        length = parts[6][:1].to(torch.int32)
        term = parts[6][1:] > 0.5
        rho = (torch.arange(L1, device=self.device)[None, :]
               < length[:, None]).to(torch.float32)
        r_scaled = (ep_rew - rs.rew_mean) * rs.rew_scale
        mode = self.algo.returns_mode
        qret = (batched_return_estimate(
            r_scaled, ep_val, ep_adv, rho, length, term, cfg.gamma,
            cfg.lambda_, mode, err_baseline=rs.max_abs_error)
            if mode != "none" else torch.zeros_like(ep_val))
        self.rs = rb.commit_episodes(
            rs, ep_states, ep_acts, ep_mus, ep_rew, ep_val, ep_adv, qret,
            rho, length, term,
            torch.ones((1,), dtype=torch.bool, device=self.device),
            cfg.maxTotObsNum, cfg.ERoldSeqFilter)
        self.n_committed_steps += int(T)

    @torch.no_grad()
    def act(self, obs_rows: np.ndarray, ready_rows=None) -> np.ndarray:
        """One batched act over ALL of the learner's lanes: obs_rows
        [n_lanes, (k+1) dimS] -> numpy [n_lanes, W] of (env action,
        action, mu, value, advantage) side by side (`split_act`). The
        recurrent contexts advance only for `ready_rows` (positions in
        self.lanes; None: every lane), by an index copy."""
        n = len(self.lanes)
        k_app = self.mdp.n_appended_obs
        rs = self.rs
        obs = _to_device(obs_rows, self.device)
        obs_std = ((obs.reshape(n, k_app + 1, -1) - rs.state_mean)
                   * rs.state_scale).reshape(n, -1)
        a, mu, val, adv, new_rnn = self.act_fn(self.params, obs_std,
                                               self.gen, self.rnn)
        if len(self.rnn) and ready_rows is not None \
                and len(ready_rows) < n:
            idx = _to_device(np.asarray(ready_rows, np.float32),
                             self.device).long()
            for old, new in zip(tree_leaves(self.rnn),
                                tree_leaves(new_rnn)):
                old.index_copy_(0, idx, new.index_select(0, idx))
        else:
            self.rnn = new_rnn
        env_a = self.mdp.learner_to_env_action(a)
        return torch.cat([x.reshape(n, -1).to(torch.float32)
                          for x in (env_a, a, mu, val, adv)], 1).cpu().numpy()

    def split_act(self, packed: np.ndarray):
        """(env action, action, mu, value, advantage) of an `act` result."""
        dA, dP = self.mdp.dim_action, self.mdp.dim_policy
        cols = np.cumsum([0, dA, dA, dP, 1, 1])
        env_a, a, mu, v, adv = (packed[:, i:j]
                                for i, j in zip(cols[:-1], cols[1:]))
        return env_a.astype(np.float64), a, mu, v[:, 0], adv[:, 0]

    # pacing (Learner::blockDataAcquisition, Learner.cpp:102-113)
    def allowed_grad_steps(self, target: int) -> int:
        allowed = int((self.n_env_steps - self.start_env_steps)
                      / self.cfg.obsPerStep) - self.n_grad
        return min(allowed, target - self.n_grad)

    def maybe_init_stats(self):
        if (not self.initialized
                and self.n_committed_steps >= self.cfg.minTotObsNum
                and int(self.rs.n_stored_steps()) >= self.cfg.minTotObsNum):
            self.rs = self._init_stats(self.rs)
            self.initialized = True
            self.start_env_steps = self.n_env_steps

    def _train_chunk(self, n: int):
        pre = None if self.sample_indices is None else self.sample_indices(n)
        self.params, self.opt_state, self.rs, m = train_chunk(
            self.algo, self.cfg, self.params, self.opt_state, self.rs,
            self.gen, n, pre)
        return m

    def train_to_pace(self, target: int, quantum: int = 100):
        """Run grad steps until the obsPerStep invariant is restored —
        called BEFORE replying to envs, so envs stall exactly like the
        reference's withheld replies (Master.cpp:118-144). A refresh runs
        whenever n_grad crosses a multiple of 1000."""
        self.maybe_init_stats()
        if not self.initialized:
            return
        while True:
            n_tr = min(quantum, self.allowed_grad_steps(target))
            if n_tr <= 0:
                return
            self._train_chunk(n_tr)
            self.n_grad += n_tr
            if self.n_grad // 1000 > self.last_refresh // 1000:
                self.last_refresh = self.n_grad
                self.rs = self._refresh(self.rs, float(self.n_grad))

    # ------------------------------------------------------------------
    def snapshot(self) -> dict:
        """Params, optimiser state and replay as copies on the CPU (named
        tuples as plain dicts) and the counters."""
        cpu = lambda x: x.detach().to("cpu", copy=True)
        return {"params": tree_map(cpu, self.params),
                "opt_state": tree_map(cpu, _plain(self.opt_state)),
                "replay": {f: cpu(getattr(self.rs, f))
                           for f in self.rs.__dataclass_fields__},
                "n_grad_steps": self.n_grad,
                "n_env_steps": self.n_env_steps,
                "initialized": self.initialized,
                "start_env_steps": self.start_env_steps}

    def restore(self, snap: dict):
        """Load a snapshot of this configuration: the params copied into
        the existing leaves, the optimiser state rebuilt in the structure
        of the current one, the replay moved to this learner's device."""
        dev = self.device
        with torch.no_grad():
            tree_map(lambda dst, src: dst.copy_(src), self.params,
                     snap["params"])
        self.opt_state = _restructure(
            self.opt_state, tree_map(lambda x: x.to(dev, copy=True),
                                     snap["opt_state"]))
        self.rs = rb.ReplayState(**{k: v.to(dev, copy=True)
                                    for k, v in snap["replay"].items()})
        self.n_grad = snap.get("n_grad_steps", 0)
        self.n_env_steps = snap.get("n_env_steps", 0)
        self.initialized = snap.get("initialized", True)
        self.start_env_steps = snap.get(
            "start_env_steps", max(0, self.n_env_steps - self.n_grad))
        self.n_committed_steps = int(self.rs.n_seen_steps)


class Engine:
    def __init__(self, argv: Optional[List[str]] = None,
                 device: str = "cuda"):
        """device: where the learners live ("cuda", "cuda:1", "cpu"); the
        card unless the caller asks for the CPU (here or by --device). A
        card that is asked for and missing raises at run()."""
        self.argv = argv or []
        self.device = device
        self.cfg = HyperParameters()
        self.n_envs = 1
        self.train_steps = 10_000_000
        self.run_dir = None
        self.restart_path = None
        self.max_ep_len = 1024
        self.n_eval_episodes = 32   # --nEvalEpisodes when bTrain == 0
        self.workers_per_env = 1    # Engine::setNworkersPerEnvironment
        self._parsed = False

    # ---------------- CLI (ExecutionInfo::parse, :95-170) ---------------
    def parse(self) -> bool:
        p = argparse.ArgumentParser(prog="smarties_tpu_torch", add_help=True)
        p.add_argument("--nEnvironments", type=int, default=1)
        p.add_argument("--nTrainSteps", type=int, default=10_000_000)
        p.add_argument("--settings", type=str, default=None)
        p.add_argument("--runDir", type=str, default=None)
        p.add_argument("--restart", type=str, default=None)
        p.add_argument("--randSeed", type=int, default=0)
        p.add_argument("--maxEpisodeLength", type=int, default=1024)
        p.add_argument("--workersPerEnvironment", type=int, default=1)
        # eval-mode flags (ExecutionInfo.cpp:95-170: --bTrain /
        # --nEvalEpisodes; eval implies restart from "." by default,
        # Engine.cpp:92-95)
        p.add_argument("--bTrain", type=int, default=1)
        p.add_argument("--nEvalEpisodes", type=int, default=0)
        p.add_argument("--device", type=str, default=None,
                       help='torch device of the learners (default "cuda")')
        try:
            args, _ = p.parse_known_args(self.argv[1:])
        except SystemExit:
            return True
        if args.settings:
            self.cfg = HyperParameters.from_json(args.settings)
        self.cfg.randSeed = args.randSeed
        self.n_envs = args.nEnvironments
        self.train_steps = args.nTrainSteps
        self.run_dir = args.runDir
        self.restart_path = args.restart
        self.max_ep_len = args.maxEpisodeLength
        self.workers_per_env = args.workersPerEnvironment
        if args.device is not None:
            self.device = args.device
        if args.nEvalEpisodes > 0:
            args.bTrain = 0
            self.n_eval_episodes = args.nEvalEpisodes
        if not args.bTrain:
            self.cfg.bTrain = 0
            if self.restart_path is None:    # Engine.cpp:92-95
                self.restart_path = os.path.join(
                    self.run_dir or ".", "checkpoint.pt")
        self._parsed = True
        return False

    # ---------------- setters (Engine.cpp:33-85) ------------------------
    def setNEnvironments(self, n: int):
        self.n_envs = n

    def setNTrainSteps(self, n: int):
        self.train_steps = n

    def setRandSeed(self, seed: int):
        self.cfg.randSeed = seed

    def setSettings(self, cfg: HyperParameters):
        self.cfg = cfg

    def setLearnerSettings(self, learner_id: int, cfg: HyperParameters):
        """Per-learner hyperparameters/algorithm override for competing
        agents — the programmatic form of the reference's per-learner
        `settings_%02u.json` lookup (AlgoFactory::findSettingsFile,
        AlgoFactory.cpp:37-58): each learner may train with a different
        algorithm and recipe (e.g. V-RACER predator vs DPG prey)."""
        if not hasattr(self, "learner_cfgs"):
            self.learner_cfgs = {}
        self.learner_cfgs[int(learner_id)] = cfg

    def _resolve_learner_cfg(self, learner_id: int) -> HyperParameters:
        """Settings for learner `learner_id`: programmatic override
        first, then `settings_%02u.json` in the run dir, then the shared
        settings (the reference falls back to `settings.json`,
        AlgoFactory.cpp:37-58)."""
        cfgs = getattr(self, "learner_cfgs", {})
        if learner_id in cfgs:
            return cfgs[learner_id]
        if self.run_dir:
            path = os.path.join(self.run_dir,
                                f"settings_{learner_id:02d}.json")
            if os.path.exists(path):
                cfg = HyperParameters.from_json(path)
                cfg.randSeed = self.cfg.randSeed
                return cfg
        return self.cfg

    def setRestartFolderPath(self, path: str):
        self.restart_path = path

    def setMaxEpisodeLength(self, n: int):
        self.max_ep_len = n

    def setNumEvaluationEpisodes(self, n: int):
        self.n_eval_episodes = n

    def setNworkersPerEnvironment(self, n: int):
        """Each env app is a team of n processes sharing a TeamComm — the
        environment_app_comm analog for multi-process simulations
        (Engine.cpp:51-55, ExecutionInfo.cpp:315-332; SURVEY §2.9 P6).
        app_main is then called as app_main(comm, team)."""
        self.workers_per_env = int(n)

    def setSimulationArgumentsFilePath(self, app_settings: str,
                                       n_step_per_file: str = ""):
        """Comma-separated staged app arg-files + per-stage step budgets
        (Engine::setSimulationArgumentsFilePath, Engine.cpp:63;
        Launcher::initArgumentFileNames, Launcher.cpp:122-151). Stage k
        activates once the env's own step counter passes the cumulative
        budget; the last stage runs forever."""
        files = [f for f in app_settings.split(",") if f]
        steps = [int(s) for s in n_step_per_file.split(",") if s] \
            if n_step_per_file else [0] * len(files)
        assert len(steps) == len(files), \
            "appSettings and nStepPappSett length mismatch"
        limits = [0]
        for s in steps[:-1]:
            limits.append(limits[-1] + s)
        self._launch_opts = dict(getattr(self, "_launch_opts", {}) or {},
                                 app_settings=files,
                                 arg_step_limits=limits)

    def setSimulationSetupFolderPath(self, folder: str):
        """Folder whose contents are copied into every per-sim run dir
        (Engine.cpp:67, Launcher::createGoRunDir setupFolder copy)."""
        self._launch_opts = dict(getattr(self, "_launch_opts", {}) or {},
                                 setup_folder=folder, sim_dirs=True)

    def setUseSimulationDirectories(self, enable: bool = True):
        """Each launch of every env app runs in its own
        simulation_%03u_%05u directory under run_dir
        (Launcher::createGoRunDir, Launcher.cpp:154-186)."""
        self._launch_opts = dict(getattr(self, "_launch_opts", {}) or {},
                                 sim_dirs=bool(enable))

    # ---------------- main loop (Engine::run, Master/Worker) ------------
    def run(self, app_main: Callable, max_wall_s: float = float("inf"),
            pool=None, serving: Optional[str] = None,
            prepare: Optional[Callable] = None):
        """app_main: python callable run in forked workers; OR pass a
        ready-made pool (e.g. runtime.socket_pool.SocketEnvPool for native
        C++/Fortran apps) and app_main is ignored.

        serving: "event" (default when the pool supports it) answers each
        env the moment its state lands — nonblocking round-robin like the
        reference's master (Master::waitForStateActionCallers,
        Core/Master.cpp:118-144), so one slow env app does not rate-limit
        the rest; "lockstep" waits for every lane each round.

        prepare(engine), when given, runs once the learners are built and
        restored, before the first round (a caller attaches counters and
        timers to `engine.learners` there)."""
        cfg = self.cfg
        device = checked_device(self.device)
        if pool is None:
            opts = dict(getattr(self, "_launch_opts", {}) or {})
            if opts and "run_dir" not in opts:
                opts["run_dir"] = self.run_dir or "."
            pool = EnvPool(app_main, self.n_envs, seed=cfg.randSeed,
                           launch_opts=opts or None,
                           workers_per_env=self.workers_per_env)
        mdp = pool.probe_spec()
        self.mdp = mdp
        n_agents = pool.n_agents
        n_lanes = pool.n_lanes
        mdps = getattr(pool, "mdps", [mdp])
        n_learners = len(mdps)

        # lane -> learner routing (Worker::getLearnerID, Worker.cpp:188:
        # learnerID == localID iff multiple learners, else 0)
        lane_learner = [(lane % n_agents) if n_learners > 1 else 0
                        for lane in range(n_lanes)]
        bundles = [_LearnerBundle(
            l, mdps[l],
            self._resolve_learner_cfg(l),
            [lane for lane in range(n_lanes) if lane_learner[lane] == l],
            self.max_ep_len, device=device) for l in range(n_learners)]
        self.learners = bundles
        self.algo = bundles[0].algo

        lanes = [_EpisodeAssembler() for _ in range(n_lanes)]
        # per-lane obs history for acting (frame stacking clamped at the
        # episode start, Episode::standardizedState)
        hist: List[list] = [[] for _ in range(n_lanes)]
        # cached per-lane stacked-frame row, refreshed only when a state
        # event arrives: the act batch stacks cached rows, so the host
        # work per poll stays O(events), not O(n_lanes x frames)
        obs_cat: List = [None] * n_lanes
        untracked = set(pool.spec.get("untracked_agents", ()))

        # eval mode (bTrain == 0, --nEvalEpisodes): serve deterministic
        # actions, no training (Engine.cpp:92-95, Worker.cpp:91-111)
        eval_mode = not cfg.bTrain
        eval_episodes_done = 0
        n_env_steps_total = 0
        obs_file = rew_file = None
        if self.run_dir:
            os.makedirs(self.run_dir, exist_ok=True)
            # raw obs logging (Agent::writeData analog, Agent.h:259-299):
            # f32 rows [lane, status, state..., reward]
            obs_file = open(os.path.join(self.run_dir,
                                         "agent_00_rank00_obs.raw"), "ab")
            rew_file = open(os.path.join(
                self.run_dir, "agent_00_rank00_cumulative_rewards.dat"), "a")

        # restart from a checkpoint (Engine::setRestartFolderPath)
        if self.restart_path and os.path.exists(self.restart_path):
            snap = torch.load(self.restart_path, map_location="cpu",
                              weights_only=True)
            if "learners" in snap:
                for b, s in zip(bundles, snap["learners"]):
                    b.restore(s)
            else:   # single-learner snapshot format
                bundles[0].restore(snap)

        def save_checkpoint():
            snap = {"learners": [b.snapshot() for b in bundles],
                    "n_grad_steps": bundles[0].n_grad,
                    "n_env_steps": bundles[0].n_env_steps,
                    "cfg": cfg.to_dict()}
            tmp = os.path.join(self.run_dir, "checkpoint.pt.tmp")
            torch.save(snap, tmp)
            os.replace(tmp, os.path.join(self.run_dir, "checkpoint.pt"))

        if prepare is not None:
            prepare(self)
        if serving is None:
            serving = "event" if hasattr(pool, "poll_states") else \
                "lockstep"
        last_save = 0
        t0 = time.time()
        try:
            while (any(b.n_grad < self.train_steps for b in bundles)
                   and time.time() - t0 < max_wall_s):
                if eval_mode and eval_episodes_done >= self.n_eval_episodes:
                    break
                # ---- serve pending envs one round ----
                if serving == "event":
                    events, ready_lanes = pool.poll_states(timeout=0.05)
                    ready = set(ready_lanes)
                else:
                    events, states, rewards, statuses = \
                        pool.gather_states()
                    ready = None    # every lane is served each round
                for lane, status, state, reward in events:
                    b = bundles[lane_learner[lane]]
                    if status == FAIL:
                        # env crashed: drop the in-progress episode and
                        # reset the agent context (Agent.h:83-86)
                        lanes[lane].reset()
                        hist[lane] = []
                        obs_cat[lane] = None
                        b.reset_rnn_lane(lane)
                        continue
                    # per-message NaN guard (Agent::checkNanOrInf,
                    # Agent.h:301-313; Communicator.cpp:267-270)
                    if not (np.isfinite(state).all()
                            and np.isfinite(reward)):
                        raise FloatingPointError(
                            f"env lane {lane} sent non-finite "
                            f"state/reward (status {status})")
                    obs = state[b.obs_idx]
                    if status == INIT:
                        hist[lane] = [obs]
                        b.reset_rnn_lane(lane)
                    else:
                        hist[lane].append(obs)
                        if len(hist[lane]) > b.mdp.n_appended_obs + 1:
                            hist[lane] = hist[lane][-(b.mdp.n_appended_obs
                                                      + 1):]
                    k_app = b.mdp.n_appended_obs
                    if k_app:
                        h = hist[lane]
                        obs_cat[lane] = np.concatenate(
                            [h[max(len(h) - 1 - j, 0)]
                             for j in range(k_app + 1)])
                    else:
                        obs_cat[lane] = obs
                    if (lane % n_agents) in untracked:
                        # acting-only agents: serve actions, store nothing
                        # (trackEpisodes=false, MemoryBuffer.cpp:50-98)
                        continue
                    if obs_file is not None:
                        row = np.concatenate([[lane, status], state,
                                              [reward]]).astype(np.float32)
                        obs_file.write(row.tobytes())
                    if eval_mode and status in (TERM, LAST):
                        eval_episodes_done += 1
                    if status == INIT:
                        lanes[lane].reset()
                        lanes[lane].add_state(obs, 0.0)
                    else:
                        lanes[lane].add_state(obs, reward)
                        b.n_env_steps += 1
                        n_env_steps_total += 1
                    if status in (TERM, LAST):
                        arrs = lanes[lane].finalize(status == TERM,
                                                    self.max_ep_len)
                        *ep_arrays, T, term, ret = arrs
                        b.commit(ep_arrays, T, term)
                        if rew_file:
                            rew_file.write(
                                f"{b.n_grad} {n_env_steps_total} "
                                f"{lane} {T} {ret}\n")

                # ---- training BEFORE replying: envs stall while the
                # learner is behind (Master.cpp:118-144 withheld replies)
                if not eval_mode:
                    for b in bundles:
                        b.train_to_pace(self.train_steps)
                    # periodic checkpoint (saveFreq, Learner.cpp:146)
                    if (self.run_dir and bundles[0].n_grad // cfg.saveFreq
                            > last_save // cfg.saveFreq):
                        last_save = bundles[0].n_grad
                        save_checkpoint()

                # ---- act on pending requests (batched per learner; the
                # batch always covers ALL of the learner's lanes — replies
                # and recurrent-state updates apply only to ready lanes) --
                env_act: List = [None] * n_lanes
                for b in bundles:
                    rows = (None if ready is None else
                            [i for i, ln in enumerate(b.lanes)
                             if ln in ready])
                    if rows is not None and not rows:
                        continue
                    k_app = b.mdp.n_appended_obs
                    zero_row = np.zeros(len(b.obs_idx) * (k_app + 1))
                    obs = np.stack([obs_cat[lane] if obs_cat[lane] is not None
                                    else zero_row for lane in b.lanes])
                    acts_env, a_np, mu_np, v_np, adv_np = b.split_act(
                        b.act(obs, rows))
                    if not np.isfinite(acts_env).all():
                        raise FloatingPointError(
                            "learning algorithm picked a nan or inf "
                            "action (Worker.cpp:151-154)")
                    for i, lane in enumerate(b.lanes):
                        if ready is not None and lane not in ready:
                            continue
                        env_act[lane] = acts_env[i]
                        if (lane % n_agents) in untracked:
                            lanes[lane].reset()
                            continue
                        lanes[lane].add_action(a_np[i], mu_np[i],
                                               v_np[i], adv_np[i])
                pool.send_actions(env_act)
        finally:
            pool.kill()
            if rew_file:
                rew_file.close()
            if obs_file:
                obs_file.close()
        # single-learner accessors
        self.params = bundles[0].params
        self.opt_state = bundles[0].opt_state
        self.replay = bundles[0].rs
        self.n_grad_steps = bundles[0].n_grad
        self.n_env_steps = n_env_steps_total if n_learners == 1 \
            else bundles[0].n_env_steps
        if self.run_dir and not eval_mode:
            save_checkpoint()
        return self.params

"""Worker-process pool hosting user environment applications.

The port's copy of smarties_tpu/runtime/env_pool.py; only the imports
point at the port. Workers are forked (`app_main` is any callable, often
a closure, which spawn could not pickle). A forked worker runs the
app's numpy code only and never touches torch: after CUDA is up in the
learner, a CUDA call in the child would raise.

Re-implements the reference's forked-env serving model
(Core/Launcher.cpp:28-69 forkApplication + Core/Master.cpp:118-144
waitForStateActionCallers): each env app runs `app_main(comm)` forever in
its own process; the learner-side pool gathers one pending state per agent
lane, batches them for a single jitted action-selection call, and scatters
the replies.

Lane model: lane = (env, agent) pair, matching the reference's agent
vector (Environment.h:42-82). An env that ends an episode (TERM/LAST)
immediately starts the next (INIT) without an action in between, so every
lane always converges to exactly one outstanding action request per round.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import time
from multiprocessing.connection import wait as _conn_wait
from typing import Callable, List, Optional, Tuple

import numpy as np

from smarties_tpu_torch.runtime.communicator import (
    CONT, FAIL, INIT, KILL_ACTION, LAST, TERM, Communicator,
    TrainingTerminated, spec_to_mdp, spec_to_mdps)


def _stage_args(comm, launch_opts: dict):
    """Pick the active appSettings file by the child-local env-step
    counter and load its tokens (Launcher::initArgumentFileNames +
    readRunArgLst, Core/Launcher.cpp:122-151,190-236; '...'-quoted groups
    become one token like the reference's apostrophe handling)."""
    files = launch_opts.get("app_settings") or []
    if not files:
        comm.app_arguments = []
        return
    limits = launch_opts.get("arg_step_limits") or [0] * len(files)
    ind = 0
    for i, lim in enumerate(limits):
        if comm.global_tstep >= lim:
            ind = i
    import shlex
    path = files[ind]
    base = launch_opts.get("run_dir") or "."
    if not os.path.isabs(path):
        path = os.path.join(base, path)
    with open(path) as f:
        comm.app_arguments = shlex.split(f.read().replace("'", '"'))


def _enter_sim_dir(env_id: int, launch_counter: int, launch_opts: dict):
    """Per-launch working directory simulation_%03u_%05u with optional
    setup-folder copy (Launcher::createGoRunDir, Core/Launcher.cpp:154-186)."""
    base = launch_opts.get("run_dir") or "."
    while True:
        d = os.path.join(base, f"simulation_{env_id:03d}_"
                               f"{launch_counter:05d}")
        if not os.path.exists(d):
            break
        launch_counter += 1
    os.makedirs(d, exist_ok=True)
    setup = launch_opts.get("setup_folder")
    if setup:
        import shutil
        for name in os.listdir(setup):
            src = os.path.join(setup, name)
            dst = os.path.join(d, name)
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                shutil.copy2(src, dst)
    os.chdir(d)
    return launch_counter


def _env_worker(app_main, conn, env_id: int, seed: int,
                launch_opts: Optional[dict] = None,
                team=None, use_shm: bool = False):
    np.random.seed(seed)
    comm = Communicator(conn, env_id, use_shm=use_shm)
    launch_opts = launch_opts or {}
    sim_dirs = launch_opts.get("sim_dirs", False)
    home = os.getcwd()
    launch_counter = 0
    try:
        while True:
            if launch_opts.get("app_settings"):
                _stage_args(comm, launch_opts)
            if sim_dirs:
                if team is not None and team.size > 1:
                    # the whole team shares one sim dir (the reference
                    # chdirs every rank of the env's app team into the
                    # same folder, Launcher::createGoRunDir)
                    if team.rank == 0:
                        launch_counter = _enter_sim_dir(
                            env_id, launch_counter, launch_opts) + 1
                        team.bcast(os.getcwd())
                    else:
                        os.chdir(team.bcast())
                else:
                    launch_counter = _enter_sim_dir(
                        env_id, launch_counter, launch_opts) + 1
            try:
                if team is not None:
                    app_main(comm, team)
                else:
                    app_main(comm)
            finally:
                if sim_dirs:
                    os.chdir(home)
    except (TrainingTerminated, EOFError, KeyboardInterrupt):
        pass
    finally:
        if comm._shm is not None:
            comm._shm.close(unlink=True)
        conn.close()


class EnvCrashed(RuntimeError):
    """An env worker died and could not be (re)spawned."""


class EnvPool:
    """max_respawns: how many times a crashed env app is restarted before
    the pool gives up (the reference only detects the crash and dies,
    Worker.cpp:146 'app crashed. TODO: handle'; here the episode is
    dropped via a FAIL event, Agent.h:83-86, and the app is relaunched).

    workers_per_env (Engine::setNworkersPerEnvironment, Engine.cpp:51-55;
    SURVEY §2.9 P6): each env is a TEAM of M processes sharing a TeamComm
    (the environment_app_comm analog, ExecutionInfo.cpp:315-332). Two
    modes, matching the reference apps:
      - distributed ENV (default): every team member is a full agent
        channel — each sends its own states and receives its own actions
        (apps/cart_pole_distribEnv); the team coordinates termination
        itself via TeamComm.
      - distributed AGENTS (app calls comm.envHasDistributedAgents()):
        ONE logical set of agents spans the team; all members send
        identical states, only rank 0's are ingested, and every member
        receives the same action reply (the MPI_Bcast over
        environment_app_comm, Worker.cpp:371-383).
    A crashed member kills and respawns its whole team (members are
    coupled by the team pipes)."""

    def __init__(self, app_main: Callable, n_envs: int, seed: int = 0,
                 max_respawns: int = 3,
                 launch_opts: Optional[dict] = None,
                 workers_per_env: int = 1, use_shm: bool = True):
        """launch_opts (Launcher.cpp:122-236 features): dict with
        sim_dirs (bool), run_dir (str), setup_folder (str),
        app_settings (list of arg-file paths),
        arg_step_limits (list of child env-step thresholds)."""
        self._ctx = mp.get_context("fork")
        self._app_main = app_main
        # shared-memory hot path (single-member pools; teams need the
        # per-member pipe lockstep and keep the pickle transport)
        self._use_shm = bool(use_shm) and int(max(1, workers_per_env)) == 1
        self._shm = {}        # member j -> attached ShmChannel
        self._shm_seen = {}   # member j -> consumed ring seq
        self._shm_q = {}      # member j -> drained-but-unreturned msgs
        self._seed = seed
        self._launch_opts = launch_opts
        self.n_envs = n_envs
        self.n_members = max(1, int(workers_per_env))
        self.max_respawns = max_respawns
        self._respawns = [0] * n_envs            # per team
        if self._use_shm:
            # the workers' slabs register with this process's resource
            # tracker: a worker forked before it runs starts a tracker of
            # its own, which outlives the worker as an orphan, and the
            # slab the worker unlinks stays registered here
            from multiprocessing import resource_tracker
            resource_tracker.ensure_running()
        n_procs = n_envs * self.n_members
        self._conns: List = [None] * n_procs     # member-indexed
        self._procs: List = [None] * n_procs
        for t in range(n_envs):
            self._spawn_team(t)
        self.spec = None
        self.mdp = None
        self.n_agents = 1
        self.dist_agents = False
        self._pending = {}   # member idx -> one buffered message

    def _spawn_team(self, t: int):
        """Fork all members of env team t with fresh team pipes."""
        from smarties_tpu_torch.runtime.team import (TeamComm,
                                                     make_team_pipes)
        M = self.n_members
        root_ends, member_ends = make_team_pipes(self._ctx, M)
        for m in range(M):
            parent, child = self._ctx.Pipe()
            team = None
            if M > 1:
                team = TeamComm(m, M,
                                root_ends if m == 0 else member_ends[m - 1])
            j = t * M + m
            p = self._ctx.Process(
                target=_env_worker,
                args=(self._app_main, child, t,
                      self._seed + j
                      + self.n_envs * M * self._respawns[t],
                      self._launch_opts, team, self._use_shm),
                daemon=True)
            p.start()
            child.close()
            self._conns[j], self._procs[j] = parent, p
        # parent keeps no team-pipe ends open
        for c in root_ends + member_ends:
            c.close()

    def probe_spec(self):
        """Wait for the first env's problem description (the reference
        broadcasts + verifies the MDP across all envs,
        Worker::synchronizeEnvironments, Worker.cpp:218-297)."""
        kind, spec = self._conns[0].recv()
        assert kind == "spec", kind
        self.spec = spec
        self.mdp = spec_to_mdp(spec)
        self.mdps = spec_to_mdps(spec)  # one per learner (different_mdps)
        self.n_agents = spec.get("n_agents", 1)
        self.dist_agents = bool(spec.get("distributed_agents", False))
        # next pipe message: the shm handshake (slab transport) or the
        # first state (pipe transport)
        msg = self._conns[0].recv()
        if not self._ctrl(0, msg):
            self._pending = {0: msg}    # first state is in
        return self.mdp

    @property
    def n_channels(self) -> int:
        """Agent channels: team roots when agents are distributed across
        the team, else every member (each member = its own agents)."""
        if self.dist_agents:
            return self.n_envs
        return self.n_envs * self.n_members

    @property
    def n_lanes(self) -> int:
        return self.n_channels * self.n_agents

    def _member_of_channel(self, c: int) -> int:
        return c * self.n_members if self.dist_agents else c

    def _attach_shm(self, j: int, msg):
        """Handle a worker's ("shm", name, n_agents, dimS, dimA, ring)
        handshake: map the slab; ring states flow from here on."""
        from smarties_tpu_torch.runtime.communicator import ShmChannel
        _, name, n_agents, ds, da, ring = msg
        old = self._shm.pop(j, None)
        if old is not None:
            old.close()
        self._shm[j] = ShmChannel.attach(name, n_agents, ds, da, ring)
        self._shm_seen[j] = 0
        self._shm_q.pop(j, None)

    def _ctrl(self, j: int, msg) -> bool:
        """True if msg is a control message (consumed here)."""
        if msg[0] == "spec":
            return True
        if msg[0] == "shm":
            self._attach_shm(j, msg)
            return True
        return False

    def _shm_next(self, j: int):
        """Next undelivered ring state of member j, or None."""
        ch = self._shm.get(j)
        if ch is None:
            return None
        q = self._shm_q.get(j)
        if not q:
            entries, seq = ch.read_new(self._shm_seen[j])
            self._shm_seen[j] = seq
            if not entries:
                return None
            self._shm_q[j] = q = entries
        return q.pop(0)

    def _drop_shm(self, j: int):
        ch = self._shm.pop(j, None)
        if ch is not None:
            ch.close(unlink=True)
        self._shm_seen.pop(j, None)
        self._shm_q.pop(j, None)

    def _recv(self, j: int):
        """Blocking recv from member j that detects a dead worker: returns
        None if the process died (the reference's crash surfaces as a FAIL
        status, Agent.h:23; detection analog of Worker.cpp:146)."""
        conn = self._conns[j]
        while True:
            msg = self._shm_next(j)
            if msg is not None:
                return msg
            try:
                if conn.poll(0.002 if j in self._shm else 0.05):
                    return conn.recv()
            except (EOFError, OSError):
                return None
            if not self._procs[j].is_alive():
                # drain anything the child flushed before dying
                msg = self._shm_next(j)
                if msg is not None:
                    return msg
                try:
                    if conn.poll(0):
                        return conn.recv()
                except (EOFError, OSError):
                    pass
                return None

    def _handle_death(self, t: int):
        """Kill + respawn the whole crashed team (or give up)."""
        M = self.n_members
        for j in range(t * M, (t + 1) * M):
            self._drop_shm(j)
            try:
                self._conns[j].close()
            except OSError:
                pass
            p = self._procs[j]
            if p is not None and p.is_alive():
                p.terminate()
                p.join(timeout=2)
        if self._respawns[t] >= self.max_respawns:
            raise EnvCrashed(
                f"env {t} crashed {self._respawns[t] + 1} times; giving up")
        self._respawns[t] += 1
        self._spawn_team(t)
        # fresh members each re-send their spec before the first state;
        # gather loops skip "spec" messages, so nothing to drain here

    def _fail_team(self, t: int, events):
        """Emit FAIL for every lane hosted by team t (episode dropped by
        the caller, Agent.h:83-86)."""
        zero = np.zeros(self.mdp.dim_state)
        if self.dist_agents:
            chans = [t]
        else:
            chans = range(t * self.n_members, (t + 1) * self.n_members)
        for c in chans:
            for a in range(self.n_agents):
                events.append((c * self.n_agents + a, FAIL, zero, 0.0))

    def _pump_channel(self, c: int, events, states, rewards, statuses):
        """Drive member channel c until each of its lanes has a pending
        action request. Returns False if the member's team died (caller
        restarts the channel scan for that team)."""
        j = self._member_of_channel(c)
        while True:
            if j in self._pending:
                msg = self._pending.pop(j)
            else:
                msg = self._recv(j)
            if msg is None:
                return False
            if self._ctrl(j, msg):
                continue
            _, agent_id, status, state, reward = msg
            lane = c * self.n_agents + agent_id
            events.append((lane, status, state, reward))
            states[lane, :len(state)] = state
            rewards[lane] = reward
            statuses[lane] = status
            # the app blocks in recvAction once its LAST agent has an
            # outstanding INIT/CONT (agents within an env act in lockstep
            # rounds, like every reference demo app) -> round complete
            if status in (INIT, CONT) and agent_id == self.n_agents - 1:
                return True

    def _drain_member(self, j: int):
        """dist-agent non-root member: consume its (duplicate) messages
        until it blocks on recvAction for its last agent. Returns False
        if the member died."""
        while True:
            if j in self._pending:
                msg = self._pending.pop(j)
            else:
                msg = self._recv(j)
            if msg is None:
                return False
            if self._ctrl(j, msg):
                continue
            _, agent_id, status, _, _ = msg
            if status in (INIT, CONT) and agent_id == self.n_agents - 1:
                return True

    # ---------------- event-driven serving (Master.cpp:118-144) ----------
    _DEAD = object()

    def _try_recv(self, j: int):
        """Nonblocking recv from member j: a message, None (nothing
        buffered), or _DEAD if the worker died — the nonblocking
        Irecv+Test of the reference's serving loop (Master.cpp:118-132).
        Ring states (shared-memory hot path) are drained first; the pipe
        carries only control traffic for shm members."""
        msg = self._shm_next(j)
        if msg is not None:
            return msg
        conn = self._conns[j]
        try:
            if conn.poll(0):
                return conn.recv()
        except (EOFError, OSError):
            return self._DEAD
        if not self._procs[j].is_alive():
            msg = self._shm_next(j)
            if msg is not None:
                return msg
            try:
                if conn.poll(0):
                    return conn.recv()
            except (EOFError, OSError):
                pass
            return self._DEAD
        return None

    def _pump_channel_nb(self, c: int) -> str:
        """Drain whatever channel c has sent so far into its round
        buffer. -> 'complete' (all lanes now have a pending action
        request), 'pending', or 'dead'."""
        j = self._member_of_channel(c)
        buf = self._chan_events.setdefault(c, [])
        while True:
            if j in self._pending:
                msg = self._pending.pop(j)
            else:
                msg = self._try_recv(j)
                if msg is self._DEAD:
                    return "dead"
                if msg is None:
                    return "pending"
            if self._ctrl(j, msg):
                continue
            _, agent_id, status, state, reward = msg
            buf.append((c * self.n_agents + agent_id, status, state,
                        reward))
            if status in (INIT, CONT) and agent_id == self.n_agents - 1:
                return "complete"

    def _drain_member_nb(self, j: int) -> str:
        """dist-agent non-root member, nonblocking drain of duplicate
        messages. -> 'complete' | 'pending' | 'dead'."""
        while True:
            if j in self._pending:
                msg = self._pending.pop(j)
            else:
                msg = self._try_recv(j)
                if msg is self._DEAD:
                    return "dead"
                if msg is None:
                    return "pending"
            if self._ctrl(j, msg):
                continue
            _, agent_id, status, _, _ = msg
            if status in (INIT, CONT) and agent_id == self.n_agents - 1:
                return "complete"

    def _team_channels(self, t: int):
        return [t] if self.dist_agents else \
            list(range(t * self.n_members, (t + 1) * self.n_members))

    def _fail_and_respawn(self, t: int, events):
        """Crash path for poll_states: drop the team's buffered partial
        rounds, emit FAIL records, respawn (Agent.h:83-86)."""
        M = self.n_members
        for c in self._team_channels(t):
            self._chan_events.pop(c, None)
            self._chan_complete.discard(c)
        for j in range(t * M, (t + 1) * M):
            self._drained.discard(j)
            self._pending.pop(j, None)
        self._fail_team(t, events)
        self._handle_death(t)

    def poll_states(self, timeout: float = 0.05):
        """Event-driven serving round (Master::waitForStateActionCallers,
        Core/Master.cpp:118-144): round-robin nonblocking receives;
        return the buffered events of every channel whose serving round
        is complete RIGHT NOW — one slow env does not rate-limit the
        rest (unlike gather_states' lockstep round). Channels with
        partially-received rounds keep them buffered for later polls.

        Returns (events, ready_lanes): `events` the ordered
        (lane, status, state, reward) records of ready channels plus
        FAIL records of crashed teams; `ready_lanes` the lanes owing an
        action reply. If nothing is ready, blocks up to `timeout` for
        the first readable channel and retries once."""
        if not hasattr(self, "_chan_events"):
            self._chan_events = {}
            self._chan_complete = set()
            self._drained = set()
        M = self.n_members
        deadline = time.monotonic() + timeout
        events: list = []
        while True:
            dead_teams = []
            for t in range(self.n_envs):
                for c in self._team_channels(t):
                    if c in self._chan_complete:
                        continue
                    st = self._pump_channel_nb(c)
                    if st == "dead":
                        dead_teams.append(t)
                        break
                    if st == "complete":
                        self._chan_complete.add(c)
                if (self.dist_agents and M > 1 and t not in dead_teams
                        and t in self._chan_complete):
                    for j in range(t * M + 1, (t + 1) * M):
                        if j in self._drained:
                            continue
                        st = self._drain_member_nb(j)
                        if st == "dead":
                            dead_teams.append(t)
                            break
                        if st == "complete":
                            self._drained.add(j)
            for t in dead_teams:
                self._fail_and_respawn(t, events)
            ready_lanes: list = []
            for c in sorted(self._chan_complete):
                if self.dist_agents and M > 1:
                    if not all(j in self._drained
                               for j in range(c * M + 1, (c + 1) * M)):
                        continue
                    for j in range(c * M + 1, (c + 1) * M):
                        self._drained.discard(j)
                events.extend(self._chan_events.pop(c, []))
                self._chan_complete.discard(c)
                ready_lanes.extend(range(c * self.n_agents,
                                         (c + 1) * self.n_agents))
            if events or ready_lanes:
                return events, ready_lanes
            left = deadline - time.monotonic()
            if left <= 0:
                return events, ready_lanes
            if self._shm:
                # ring traffic does not signal the pipes: short sleep-poll
                time.sleep(min(left, 2e-4))
                continue
            alive = [conn for conn in self._conns if conn is not None]
            try:
                _conn_wait(alive, timeout=left)
            except OSError:
                pass

    def gather_states(self):
        """Collect, per lane, messages until each lane has a pending
        action request (INIT/CONT) — TERM/LAST messages are returned as
        completed-step records without action requests. A crashed worker
        yields FAIL events for its team's lanes (episode dropped by the
        caller, Agent.h:83-86) and the team is respawned.

        Returns (events, states [n_lanes, dimS], rewards [n_lanes],
                 statuses [n_lanes]).
        """
        n = self.n_lanes
        # rows sized to the largest per-agent state (per-agent MDPs may
        # declare different dims); shorter states are zero-padded
        dim_s = max(m.dim_state for m in getattr(self, "mdps", [self.mdp]))
        states = np.zeros((n, dim_s), np.float64)
        rewards = np.zeros(n)
        statuses = np.full(n, -1, np.int64)
        events = []   # ordered (lane, status, state, reward) records
        M = self.n_members
        for t in range(self.n_envs):
            while True:   # restart the team's scan after a respawn
                if self.dist_agents:
                    chans = [t]
                else:
                    chans = range(t * M, (t + 1) * M)
                ok = all(self._pump_channel(c, events, states, rewards,
                                            statuses) for c in chans)
                if ok and self.dist_agents and M > 1:
                    ok = all(self._drain_member(j)
                             for j in range(t * M + 1, (t + 1) * M))
                if ok:
                    break
                self._fail_team(t, events)
                self._handle_death(t)
        return events, states, rewards, statuses

    def send_actions(self, env_actions: np.ndarray):
        """Reply one action per lane (lane-major order); a None entry
        skips that lane (event-driven partial rounds reply only to ready
        lanes). When agents are distributed across a team, every member
        gets the same replies (action MPI_Bcast analog,
        Worker.cpp:371-383)."""
        for c in range(self.n_channels):
            j = self._member_of_channel(c)
            ch = self._shm.get(j)
            if ch is not None:
                # slab hot path: row writes + ONE round publish
                wrote = False
                for a in range(self.n_agents):
                    lane = c * self.n_agents + a
                    if env_actions[lane] is None:
                        continue
                    ch.write_action(a, env_actions[lane])
                    wrote = True
                if wrote:
                    ch.publish_round()
                    try:    # raw 1-byte wake token: the worker blocks on
                        # the pipe instead of spinning (few-core hosts);
                        # os.write skips the Connection framing
                        os.write(self._conns[j].fileno(), ch.TOKEN)
                    except (BrokenPipeError, OSError):
                        pass
                continue
            if self.dist_agents and self.n_members > 1:
                conns = self._conns[c * self.n_members:
                                    (c + 1) * self.n_members]
            else:
                conns = [self._conns[j]]
            for a in range(self.n_agents):
                lane = c * self.n_agents + a
                if env_actions[lane] is None:
                    continue
                for conn in conns:
                    try:
                        conn.send(env_actions[lane])
                    except (BrokenPipeError, OSError):
                        pass  # death is detected on the next gather round

    def kill(self):
        for ch in self._shm.values():
            ch.set_kill()
        for conn in self._conns:
            try:
                conn.send(KILL_ACTION)
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()

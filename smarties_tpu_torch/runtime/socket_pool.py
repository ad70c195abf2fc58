"""UNIX-socket transport for native (C++/C/Fortran) environment apps.

The port's copy of smarties_tpu/runtime/socket_pool.py; only the
imports point at the port.

Learner-side counterpart of native/smarties_tpu.{h,cpp}: listens on a
UNIX-domain socket, spawns (or accepts) N env-app processes, and exposes
the same gather_states / send_actions interface as the python EnvPool
(runtime/env_pool.py), so the Engine serves both transports identically.

Env teams (Engine::setNworkersPerEnvironment; SURVEY §2.9 P6): with
workers_per_env = M each env is a team of M processes, each owning its
OWN socket. The client's spec carries (env_id, team_rank, team_size) —
either from Communicator::set_team (an MPI app passes its own MPI
rank/size) or from the SMARTIES_TPU_ENV_ID/TEAM_RANK/TEAM_SIZE env vars
this pool sets when it spawns the team. When the app declares
distributed agents (env_has_distributed_agents), only rank 0's states
are ingested and every rank receives the same action reply — the
library-side analog of the reference's action MPI_Bcast over
environment_app_comm (Core/Worker.cpp:371-383).

This is the analog of the reference's Launcher::forkApplication + SocketsLib
(Core/Launcher.cpp:28-69, Utils/SocketsLib.h) with this framework's own
wire protocol (see native/smarties_tpu.h).
"""
from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np

from smarties_tpu_torch.runtime.communicator import (CONT, FAIL, INIT, LAST,
                                                     TERM, spec_to_mdp)

MAGIC_SPEC = 0x43455053
MAGIC_STAT = 0x54415453
MAGIC_ACTN = 0x4E544341
MAGIC_KILL = 0x4C4C494B


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise EOFError("env app closed the connection")
        buf += chunk
    return buf


class SocketEnvPool:
    """Drop-in alternative to EnvPool for native apps.

    Args:
      command: argv to launch ONE env app process (launched
               n_envs * workers_per_env times with SMARTIES_TPU_SOCKET
               and the team-identity env vars set), or None to only
               accept externally-started clients (e.g. an mpirun whose
               ranks each call set_team).
      workers_per_env: team size M per env (env teams / MPI apps).
    """

    def __init__(self, command: Optional[Sequence[str]], n_envs: int,
                 socket_path: Optional[str] = None,
                 workers_per_env: int = 1):
        self.n_envs = n_envs
        self.n_members = max(1, int(workers_per_env))
        self.socket_path = socket_path or os.path.join(
            tempfile.mkdtemp(prefix="smarties_tpu_"), "comm.sock")
        self._server = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._server.bind(self.socket_path)
        n_procs = n_envs * self.n_members
        self._server.listen(n_procs)
        self._procs = []
        if command is not None:
            for t in range(n_envs):
                for m in range(self.n_members):
                    env = dict(os.environ,
                               SMARTIES_TPU_SOCKET=self.socket_path,
                               SMARTIES_TPU_ENV_ID=str(t),
                               SMARTIES_TPU_TEAM_RANK=str(m),
                               SMARTIES_TPU_TEAM_SIZE=str(self.n_members))
                    self._procs.append(
                        subprocess.Popen(list(command), env=env))
        self._raw_conns: List[socket.socket] = []
        for _ in range(n_procs):
            conn, _ = self._server.accept()
            self._raw_conns.append(conn)
        self.spec = None
        self.mdp = None
        self.n_agents = 1
        self.dist_agents = False
        self._conns: List[socket.socket] = list(self._raw_conns)
        self._pending = [None] * n_procs

    # ---------------- message parsing ----------------
    def _recv_raw(self, conn: socket.socket):
        magic, = struct.unpack("<I", _read_exact(conn, 4))
        if magic == MAGIC_SPEC:
            ln, = struct.unpack("<I", _read_exact(conn, 4))
            spec = json.loads(_read_exact(conn, ln).decode())
            return ("spec", spec)
        if magic == MAGIC_STAT:
            agent, status, dim = struct.unpack("<III",
                                               _read_exact(conn, 12))
            state = np.frombuffer(_read_exact(conn, 8 * dim), np.float64)
            reward, = struct.unpack("<d", _read_exact(conn, 8))
            return ("state", agent, status, state.copy(), reward)
        raise ValueError(f"bad magic {magic:#x}")

    def _recv_msg(self, j: int):
        msg = self._recv_raw(self._conns[j])
        if msg[0] == "spec":
            return ("spec", self._normalize_spec(msg[1]))
        return msg

    @staticmethod
    def _normalize_spec(spec: dict) -> dict:
        out = {"dim_state": spec.get("dim_state"),
               "dim_action": spec.get("dim_action"),
               "bounded": tuple(spec["bounded"]) if "bounded" in spec
               else None,
               "upper": tuple(spec.get("upper", ())) or None,
               "lower": tuple(spec.get("lower", ())) or None,
               "discrete_values": tuple(spec.get("discrete_values", ())),
               "observable": tuple(spec["observable"])
               if "observable" in spec else None,
               "n_agents": spec.get("n_agents", 1),
               "n_appended_obs": spec.get("n_appended_obs", 0),
               "distributed_agents":
                   bool(spec.get("distributed_agents", False)),
               "conv_layers": tuple(tuple(c) for c in
                                    spec.get("conv_layers", ()))}
        return out

    # ---------------- EnvPool interface ----------------
    def probe_spec(self):
        """Read every connection's spec message, reorder connections by
        the declared (env_id, team_rank) — concurrent connects arrive in
        arbitrary order — and buffer each connection's first state
        (reference Worker::synchronizeEnvironments broadcast+verify,
        Worker.cpp:218-297)."""
        M = self.n_members
        placed: List[Optional[socket.socket]] = \
            [None] * (self.n_envs * M)
        pending = [None] * (self.n_envs * M)
        unplaced = []
        for conn in self._raw_conns:
            kind, raw = self._recv_raw(conn)
            assert kind == "spec", kind
            spec = dict(raw)
            if self.spec is None:
                self.spec = self._normalize_spec(spec)
            j = None
            if "team_rank" in spec or "env_id" in spec:
                j = (int(spec.get("env_id", 0)) * M
                     + int(spec.get("team_rank", 0)))
                if not (0 <= j < len(placed)) or placed[j] is not None:
                    j = None     # bad/duplicate identity: accept-order
            if j is None:
                unplaced.append(conn)
            else:
                placed[j] = conn
        free = iter([i for i, c in enumerate(placed) if c is None])
        for conn in unplaced:
            placed[next(free)] = conn
        self._conns = placed
        self.mdp = spec_to_mdp(self.spec)
        self.n_agents = self.spec.get("n_agents", 1)
        self.dist_agents = bool(self.spec.get("distributed_agents"))
        self._pending = pending
        return self.mdp

    @property
    def n_channels(self) -> int:
        """Agent channels: team roots when agents are distributed across
        the team, else every member."""
        if self.dist_agents:
            return self.n_envs
        return self.n_envs * self.n_members

    @property
    def n_lanes(self) -> int:
        return self.n_channels * self.n_agents

    def _member_of_channel(self, c: int) -> int:
        return c * self.n_members if self.dist_agents else c

    # ---------------- event-driven serving (Master.cpp:118-144) --------
    def _try_read_msgs(self, j: int):
        """Nonblocking framed reader for member j: drains whatever bytes
        are available into a per-connection buffer and yields complete
        messages. The reference's SOCKET_Irecv + Test pair
        (Utils/SocketsLib.h) collapses to buffered parsing here."""
        if not hasattr(self, "_rbuf"):
            self._rbuf = [b""] * len(self._conns)
        conn = self._conns[j]
        conn.setblocking(False)
        try:
            while True:
                try:
                    chunk = conn.recv(65536)
                except BlockingIOError:
                    break
                if not chunk:
                    raise EOFError("env app closed the connection")
                self._rbuf[j] += chunk
        finally:
            conn.setblocking(True)
        out = []
        buf = self._rbuf[j]
        while True:
            if len(buf) < 4:
                break
            magic, = struct.unpack("<I", buf[:4])
            if magic == MAGIC_SPEC:
                if len(buf) < 8:
                    break
                ln, = struct.unpack("<I", buf[4:8])
                if len(buf) < 8 + ln:
                    break
                spec = json.loads(buf[8:8 + ln].decode())
                out.append(("spec", self._normalize_spec(spec)))
                buf = buf[8 + ln:]
            elif magic == MAGIC_STAT:
                if len(buf) < 16:
                    break
                agent, status, dim = struct.unpack("<III", buf[4:16])
                need = 16 + 8 * dim + 8
                if len(buf) < need:
                    break
                state = np.frombuffer(buf[16:16 + 8 * dim], np.float64)
                reward, = struct.unpack("<d", buf[16 + 8 * dim:need])
                out.append(("state", agent, status, state.copy(), reward))
                buf = buf[need:]
            else:
                raise ValueError(f"bad magic {magic:#x}")
        self._rbuf[j] = buf
        return out

    def poll_states(self, timeout: float = 0.05):
        """Event-driven serving round for native apps: return the
        buffered events of every channel whose round is complete RIGHT
        NOW (all its lanes have pending action requests) — a slow
        simulation never rate-limits the rest (Master.cpp:118-144).
        Same contract as EnvPool.poll_states."""
        import time as _time
        from multiprocessing.connection import wait as _w
        if not hasattr(self, "_chan_events"):
            self._chan_events = {}
            self._chan_complete = set()
            self._drain_left = {}    # member j -> duplicate rounds owed
        M = self.n_members
        if not hasattr(self, "_dead_chans"):
            self._dead_chans = set()
        deadline = _time.monotonic() + timeout
        while True:
            for c in range(self.n_channels):
                if c in self._dead_chans:
                    continue
                j = self._member_of_channel(c)
                buf = self._chan_events.setdefault(c, [])
                if c not in self._chan_complete:
                    if self._pending[j] is not None:
                        msgs = [self._pending[j]]
                        self._pending[j] = None
                    else:
                        msgs = []
                    try:
                        msgs += self._try_read_msgs(j)
                    except (EOFError, OSError):
                        # client crash mid-stream: surface one FAIL event
                        # per lane (EnvPool parity, Agent FAIL status) and
                        # retire the channel — the event-driven loop keeps
                        # serving the healthy channels (the reference
                        # die()s the whole run here, SocketsLib.h)
                        self._dead_chans.add(c)
                        for a in range(self.n_agents):
                            buf.append((c * self.n_agents + a, FAIL,
                                        np.zeros(self.mdp.dim_state),
                                        0.0))
                        self._chan_complete.add(c)
                        msgs = []
                    for msg in msgs:
                        if msg[0] == "spec":
                            continue
                        _, agent_id, status, state, reward = msg
                        buf.append((c * self.n_agents + agent_id, status,
                                    state, reward))
                        if (status in (INIT, CONT)
                                and agent_id == self.n_agents - 1):
                            self._chan_complete.add(c)
                if self.dist_agents and M > 1:
                    # count each non-root member's completed duplicate
                    # rounds so replies stay in lockstep with its stream
                    for jj in range(c * M + 1, (c + 1) * M):
                        for msg in self._try_read_msgs(jj):
                            if msg[0] == "spec":
                                continue
                            _, agent_id, status, _s, _r = msg
                            if (status in (INIT, CONT)
                                    and agent_id == self.n_agents - 1):
                                self._drain_left[jj] = \
                                    self._drain_left.get(jj, 0) + 1
            events, ready = [], []
            for c in sorted(self._chan_complete):
                if self.dist_agents and M > 1:
                    if not all(self._drain_left.get(jj, 0) > 0
                               for jj in range(c * M + 1, (c + 1) * M)):
                        continue
                    for jj in range(c * M + 1, (c + 1) * M):
                        self._drain_left[jj] -= 1
                events.extend(self._chan_events.pop(c, []))
                self._chan_complete.discard(c)
                ready.extend(range(c * self.n_agents,
                                   (c + 1) * self.n_agents))
            if events or ready:
                return events, ready
            left = deadline - _time.monotonic()
            if left <= 0:
                return events, ready
            try:
                _w(self._conns, timeout=left)
            except OSError:
                pass

    def _pump(self, j: int, sink):
        """Receive from member j until its last agent has a pending
        action request; `sink(agent_id, status, state, reward)` gets
        every state record (None sink = drain duplicates)."""
        while True:
            if self._pending[j] is not None:
                msg, self._pending[j] = self._pending[j], None
            else:
                msg = self._recv_msg(j)
            if msg[0] == "spec":
                continue
            _, agent_id, status, state, reward = msg
            if sink is not None:
                sink(agent_id, status, state, reward)
            if status in (INIT, CONT) and agent_id == self.n_agents - 1:
                return

    def gather_states(self):
        # one serving mode per pool instance: poll_states parks partial
        # frames in _rbuf/_chan_events which _recv_msg cannot see — a
        # later blocking gather would misparse mid-message ("bad magic").
        # Guard the invariant explicitly (ADVICE r3 #3).
        if (any(getattr(self, "_rbuf", [])) or
                any(getattr(self, "_chan_events", {}).values())):
            raise RuntimeError(
                "SocketEnvPool: gather_states called while poll_states "
                "holds buffered partial frames — pick ONE serving mode "
                "(event-driven poll_states OR lockstep gather_states) "
                "per pool instance")
        n = self.n_lanes
        states = np.zeros((n, self.mdp.dim_state), np.float64)
        rewards = np.zeros(n)
        statuses = np.full(n, -1, np.int64)
        events = []
        M = self.n_members
        for c in range(self.n_channels):
            j = self._member_of_channel(c)

            def sink(agent_id, status, state, reward, c=c):
                lane = c * self.n_agents + agent_id
                events.append((lane, status, state, reward))
                states[lane] = state
                rewards[lane] = reward
                statuses[lane] = status

            self._pump(j, sink)
            if self.dist_agents and M > 1:
                # drain the other ranks' duplicate streams so the team
                # stays in lockstep with its root (Worker.cpp:371-383)
                for jj in range(c * M + 1, (c + 1) * M):
                    self._pump(jj, None)
        return events, states, rewards, statuses

    def send_actions(self, env_actions: np.ndarray):
        """Reply one action per lane; with distributed agents every team
        member receives the same replies (the action MPI_Bcast analog,
        Core/Worker.cpp:371-383). None entries skip the lane."""
        M = self.n_members
        for c in range(self.n_channels):
            if c in getattr(self, "_dead_chans", ()):
                continue       # crashed client (FAIL already surfaced)
            if self.dist_agents and M > 1:
                conns = self._conns[c * M:(c + 1) * M]
            else:
                conns = [self._conns[self._member_of_channel(c)]]
            for a in range(self.n_agents):
                lane = c * self.n_agents + a
                if env_actions[lane] is None:
                    continue
                act = np.asarray(env_actions[lane], np.float64).ravel()
                msg = struct.pack("<II", MAGIC_ACTN, act.size) \
                    + act.tobytes()
                for conn in conns:
                    conn.sendall(msg)

    def kill(self):
        for conn in self._conns:
            try:
                conn.sendall(struct.pack("<I", MAGIC_KILL))
                conn.close()
            except OSError:
                pass
        for p in self._procs:
            try:
                p.wait(timeout=2)
            except subprocess.TimeoutExpired:
                p.terminate()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

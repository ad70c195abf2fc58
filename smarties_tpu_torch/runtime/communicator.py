"""User-facing environment API: the Communicator.

The port's copy of smarties_tpu/runtime/communicator.py, line for line
but for `spec_to_mdp`, which builds the port's MDPSpec. The wire format
and the shared-memory slab layout are the JAX package's byte for byte:
native/ speaks them. The port keeps a copy rather than importing the
original, whose package imports jax.

Re-implements the reference's inverted-control env interface
(source/smarties/Communicator.{h,cpp}): user applications drive the control
flow and call sendInitState / sendState / sendTermState / sendLastState /
recvAction; problem-description setters declare dims, bounds, discrete
options, observability, multi-agent counts.

Transport: the reference forks env processes connected by AF_UNIX sockets
(Utils/SocketsLib.h, Core/Launcher.cpp:28-69); here env worker processes
talk to the learner over multiprocessing pipes for control messages
(spec, crash detection, KILL) while the per-step state/action hot path
rides a SHARED-MEMORY slab (ShmChannel below) — the zero-copy analog of
the reference's in-process SocketsLib buffers: pickling one state tuple
through a pipe costs ~45 us; a slab row write + seqlock bump costs ~1 us
(r4 serving_bench: 8.3k -> >20k states/s at 64 envs).
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence

import numpy as np

# episode status codes (Core/Agent.h:23)
INIT, CONT, TERM, LAST, FAIL = 0, 1, 2, 3, 4
KILL_ACTION = "__KILL__"


class TrainingTerminated(Exception):
    """Raised inside the app loop when the learner sends KILL
    (Communicator::terminateTraining, Communicator.cpp:292-296)."""


class ShmChannel:
    """Single-producer/single-consumer shared-memory state/action slab
    between one env worker process and the master.

    Layout (all offsets in elements):
      header   int64[8]: [state_seq, action_round, kill_flag, ring_len,
                          dim_state, dim_action, n_agents, 0]
      ring     ring_len x (3 + dim_state) float64 rows:
                          [agent_id, status, reward, state...]
      actions  n_agents x dim_action float64

    The worker writes a ring row then increments state_seq (x86 TSO
    keeps the payload visible before the counter — the same seqlock
    discipline as the reference's lock-free SocketsLib buffers); the
    master drains rows it has not consumed yet. Action replies go the
    other way: the master fills the action rows for the worker's agents,
    increments action_round once per serving round, then sends a ONE-
    BYTE wake token down the pipe — the worker BLOCKS on the pipe (a
    kernel wakeup, not a spin: the serving host may have very few cores
    and dozens of env workers; spinning starves everyone) and reads its
    row from the slab. The pipe stays in place for spec/crash/KILL
    control flow."""

    TOKEN = b"A"

    HDR = 8

    def __init__(self, shm, n_agents: int, dim_state: int,
                 dim_action: int, ring_len: int):
        self._shm = shm
        self.n_agents, self.ring_len = n_agents, ring_len
        self.dim_state, self.dim_action = dim_state, dim_action
        row = 3 + dim_state
        h = self.HDR
        self.hdr = np.ndarray((h,), np.int64, shm.buf)
        self.ring = np.ndarray((ring_len, row), np.float64, shm.buf,
                               offset=8 * h)
        self.acts = np.ndarray((n_agents, dim_action), np.float64,
                               shm.buf, offset=8 * (h + ring_len * row))

    # ---------------- construction ----------------
    @classmethod
    def create(cls, n_agents: int, dim_state: int, dim_action: int):
        from multiprocessing import shared_memory
        ring_len = 8 * max(1, n_agents)
        row = 3 + dim_state
        size = 8 * (cls.HDR + ring_len * row + n_agents * dim_action)
        shm = shared_memory.SharedMemory(create=True, size=size)
        ch = cls(shm, n_agents, dim_state, dim_action, ring_len)
        ch.hdr[:] = 0
        ch.hdr[3:7] = (ring_len, dim_state, dim_action, n_agents)
        return ch

    @classmethod
    def attach(cls, name: str, n_agents: int, dim_state: int,
               dim_action: int, ring_len: int):
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=name)
        return cls(shm, n_agents, dim_state, dim_action, ring_len)

    @property
    def name(self):
        return self._shm.name

    def handshake(self):
        """The pipe message announcing this channel to the master."""
        return ("shm", self.name, self.n_agents, self.dim_state,
                self.dim_action, self.ring_len)

    # ---------------- worker side ----------------
    def push_state(self, agent_id: int, status: int, state, reward):
        seq = int(self.hdr[0])
        row = self.ring[seq % self.ring_len]
        row[0] = agent_id
        row[1] = status
        row[2] = reward
        row[3:3 + len(state)] = state
        if len(state) < self.dim_state:
            row[3 + len(state):] = 0.0
        self.hdr[0] = seq + 1          # publish (TSO: payload first)

    def wait_action(self, agent_id: int, target_round: int, conn,
                    tokens_taken: int):
        """Block on the pipe wake token until the master publishes round
        `target_round`; returns (action row copy, tokens_taken). Raises
        TrainingTerminated on the kill flag / a KILL payload."""
        fd = conn.fileno()
        while tokens_taken < target_round:
            if int(self.hdr[2]):
                raise TrainingTerminated()
            try:
                # raw single-byte wake (written with os.write master-side
                # to skip Connection framing); any other byte (e.g. the
                # first byte of a pickled KILL frame) means shutdown
                data = os.read(fd, 1)
            except OSError:
                raise TrainingTerminated()
            if data != self.TOKEN:
                raise TrainingTerminated()
            tokens_taken += 1
        if int(self.hdr[2]):
            raise TrainingTerminated()
        return self.acts[agent_id].copy(), tokens_taken

    # ---------------- master side ----------------
    def read_new(self, consumed: int):
        """Rows published since `consumed`; returns (entries, new_seq)
        where entries are ("state", agent, status, state, reward)
        tuples (the pipe-message shape)."""
        seq = int(self.hdr[0])
        out = []
        for s in range(consumed, seq):
            row = self.ring[s % self.ring_len]
            out.append(("state", int(row[0]), int(row[1]),
                        row[3:].copy(), float(row[2])))
        return out, seq

    def write_action(self, agent_id: int, action):
        a = np.asarray(action, np.float64).ravel()
        self.acts[agent_id, :a.size] = a

    def publish_round(self):
        self.hdr[1] = int(self.hdr[1]) + 1

    def set_kill(self):
        try:
            self.hdr[2] = 1
        except (ValueError, OSError):
            pass

    def close(self, unlink: bool = False):
        self.hdr = self.ring = self.acts = None
        try:
            self._shm.close()
            if unlink:
                self._shm.unlink()
        except (FileNotFoundError, OSError):
            pass


class Communicator:
    """Child-process side. One per env process; supports multiple agents
    per env (setNumAgents, Communicator.h:117)."""

    def __init__(self, conn, env_id: int = 0, use_shm: bool = False):
        self._conn = conn
        self.env_id = env_id
        # shared-memory hot path (created lazily at the first state send,
        # once the problem dims are known; see ShmChannel)
        self._use_shm = bool(use_shm)
        self._shm = None
        self._shm_rounds = None   # per-agent action-round counters
        self._shm_tokens = 0      # wake tokens consumed (== rounds seen)
        # staged app arguments for this launch (Launcher::readRunArgLst,
        # Core/Launcher.cpp:190-236): tokens of the active appSettings file
        self.app_arguments: List[str] = []
        # child-local total env-step counter driving the arg-file schedule
        # (globalTstepCounter vs argFilesStepsLimits, Launcher.cpp:95-102)
        self.global_tstep = 0
        self._spec = {
            "dim_state": None, "dim_action": None,
            "bounded": None, "upper": None, "lower": None,
            "discrete_values": (), "observable": None,
            "n_agents": 1, "n_appended_obs": 0,
            # per-agent MDP overrides, keyed by localID; active when
            # different_mdps (agentsDefineDifferentMDP, Communicator.cpp:207)
            "agent_overrides": {}, "different_mdps": False,
        }
        self._spec_sent = False
        self._started = [False]

    def _set(self, agent_id: int, **kv):
        """Route a problem-description field to the shared spec (agent 0)
        or a per-agent override (Communicator.cpp: every setter indexes
        ENV.descriptors[agentID])."""
        if agent_id == 0:
            self._spec.update(kv)
        else:
            ov = self._spec["agent_overrides"].setdefault(int(agent_id), {})
            ov.update(kv)

    # ---------------- problem description (Communicator.h:90-141) -------
    def setStateActionDims(self, dim_state: int, dim_action: int,
                           agent_id: int = 0):
        self._set(agent_id, dim_state=int(dim_state),
                  dim_action=int(dim_action))

    def setActionScales(self, upper: Sequence[float],
                        lower: Sequence[float], areBounds: bool = True,
                        agent_id: int = 0):
        n = len(upper)
        self._set(agent_id,
                  upper=tuple(float(u) for u in upper),
                  lower=tuple(float(l) for l in lower),
                  bounded=tuple([bool(areBounds)] * n))

    def setActionOptions(self, options, agent_id: int = 0):
        """Discrete actions: number of options per action component
        (Communicator::setActionOptions)."""
        if np.isscalar(options):
            options = [options]
        self._set(agent_id,
                  discrete_values=tuple(int(o) for o in options))

    def setStateObservable(self, observable: Sequence[bool],
                           agent_id: int = 0):
        self._set(agent_id, observable=tuple(bool(b) for b in observable))

    def setStateScales(self, upper, lower, agent_id: int = 0):
        """Rough state box used to SEED the standardization stats until
        the online estimates warm up (Communicator.cpp:98-122: "serves
        only as an optional initialization for statistics")."""
        self._set(agent_id, state_upper=tuple(map(float, upper)),
                  state_lower=tuple(map(float, lower)))

    def setNumAgents(self, n: int):
        self._spec["n_agents"] = int(n)
        self._started = [False] * int(n)

    def agentsDefineDifferentMDP(self):
        """Each agent within an env gets its own MDP and its own learner
        (competing-agents mode). Reference: Communicator.cpp:207-219
        (ENV.initDescriptors(true)); routing Worker.cpp:148,188 maps
        localID -> learners[localID]. Call after setNumAgents; setters then
        take agent_id to describe each agent's problem."""
        assert self._spec["n_agents"] > 1, \
            "call setNumAgents(>1) before agentsDefineDifferentMDP"
        # mutually exclusive with distributed agents (the reference
        # die()s on the combination, Communicator.cpp:200-205)
        assert not self._spec.get("distributed_agents"), \
            "envHasDistributedAgents and agentsDefineDifferentMDP " \
            "are mutually exclusive (Communicator.cpp:200-205)"
        self._spec["different_mdps"] = True

    def setNumAppendedPastObservations(self, n: int):
        self._spec["n_appended_obs"] = int(n)

    def envHasDistributedAgents(self):
        """The SAME logical agents span every process of the env team
        (Communicator::envHasDistributedAgents, Communicator.cpp:221-235):
        all team members send identical states, only rank 0's are
        ingested, and every member receives the same action reply
        (the action MPI_Bcast over environment_app_comm,
        Worker.cpp:371-383). See apps/cart_pole_distribAgent."""
        assert not self._spec.get("different_mdps"), \
            "envHasDistributedAgents and agentsDefineDifferentMDP " \
            "are mutually exclusive (Communicator.cpp:200-205)"
        self._spec["distributed_agents"] = True

    def setIsPartiallyObservable(self, agent_id: int = 0):
        self._spec["partially_observable"] = True

    def agentsShareExplorationNoise(self, agent_id: int = 0):
        """All agents of one env draw the same exploration noise each step
        (Communicator.h:133, Agent.h:315-342)."""
        self._spec["shared_noise"] = True

    def disableDataTrackingForAgents(self, first_agent: int,
                                     last_agent: int):
        """Agents in [first, last) act but their transitions are not stored
        (Communicator::disableDataTrackingForAgents — evaluation-only or
        scripted agents in multi-agent envs)."""
        untracked = set(self._spec.get("untracked_agents", ()))
        untracked.update(range(first_agent, last_agent))
        self._spec["untracked_agents"] = tuple(sorted(untracked))

    def setPreprocessingConv2d(self, input_width: int, input_height: int,
                               input_features: int, kernels_num: int,
                               filters_size: int, stride: int,
                               agent_id: int = 0):
        """Append a conv layer to the preprocessing stack
        (Communicator.cpp:135-160)."""
        convs = list(self._spec.get("conv_layers", ()))
        convs.append((int(input_width), int(input_height),
                      int(input_features), int(kernels_num),
                      int(filters_size), int(stride)))
        self._spec["conv_layers"] = tuple(convs)

    # ---------------- episode flow (Communicator.h:52-88) ---------------
    def _agent_dims(self):
        """(max dim_state, max dim_action) across per-agent overrides."""
        ds = [self._spec["dim_state"]]
        da = [self._spec["dim_action"]]
        for ov in self._spec["agent_overrides"].values():
            ds.append(ov.get("dim_state", ds[0]))
            da.append(ov.get("dim_action", da[0]))
        return max(d for d in ds if d), max(d for d in da if d)

    def _agent_dim_action(self, agent_id: int) -> int:
        ov = self._spec["agent_overrides"].get(int(agent_id), {})
        return int(ov.get("dim_action", self._spec["dim_action"]))

    def _send(self, status: int, state, reward: float, agent_id: int):
        if not self._spec_sent:
            self._conn.send(("spec", self._spec))
            self._spec_sent = True
            if self._use_shm:
                ds, da = self._agent_dims()
                n_ag = int(self._spec.get("n_agents", 1))
                self._shm = ShmChannel.create(n_ag, ds, da)
                self._shm_rounds = [0] * n_ag
                self._conn.send(self._shm.handshake())
        state = np.asarray(state, np.float64)
        if status != INIT:
            self.global_tstep += 1
        if self._shm is not None:
            self._shm.push_state(agent_id, status, state, float(reward))
        else:
            self._conn.send(("state", agent_id, status, state,
                             float(reward)))

    def sendInitState(self, state, agent_id: int = 0):
        self._started[agent_id] = True
        self._send(INIT, state, 0.0, agent_id)

    def sendState(self, state, reward: float, agent_id: int = 0):
        self._send(CONT, state, reward, agent_id)

    def sendTermState(self, state, reward: float, agent_id: int = 0):
        self._send(TERM, state, reward, agent_id)

    def sendLastState(self, state, reward: float, agent_id: int = 0):
        self._send(LAST, state, reward, agent_id)

    def recvAction(self, agent_id: int = 0) -> np.ndarray:
        if self._shm is not None:
            self._shm_rounds[agent_id] += 1
            row, self._shm_tokens = self._shm.wait_action(
                agent_id, self._shm_rounds[agent_id], self._conn,
                self._shm_tokens)
            return row[:self._agent_dim_action(agent_id)]
        msg = self._conn.recv()
        if isinstance(msg, str) and msg == KILL_ACTION:
            raise TrainingTerminated()
        return np.asarray(msg, np.float64)

    def recvDiscreteAction(self, agent_id: int = 0) -> int:
        return int(self.recvAction(agent_id)[0])

    def terminateTraining(self):
        raise TrainingTerminated()

    # sugar for stateless optimization problems (Communicator.h:148-161)
    def getOptimizationParameters(self, agent_id: int = 0) -> np.ndarray:
        self.sendInitState(np.zeros(1), agent_id)
        return self.recvAction(agent_id)

    def setOptimizationEvaluation(self, result: float, agent_id: int = 0):
        self.sendTermState(np.zeros(1), -float(result), agent_id)


def spec_to_mdp(spec: dict, agent_id: int = 0):
    """Build an MDPSpec from a Communicator problem description.

    agent_id selects the per-agent descriptor when the env declared
    different MDPs per agent (Environment::initDescriptors(true),
    Environment.h:84-97); otherwise all agents share descriptor 0."""
    from smarties_tpu_torch.core.mdp import MDPSpec
    if agent_id and spec.get("different_mdps"):
        # per-agent override on top of the shared (agent-0) description
        spec = dict(spec, **spec.get("agent_overrides", {}).get(
            int(agent_id), {}))
    dim_s, dim_a = spec["dim_state"], spec["dim_action"]
    assert dim_s is not None and dim_a is not None, \
        "env must call setStateActionDims before sending states"
    kw = dict(dim_state=dim_s, dim_action=dim_a,
              n_agents_per_env=spec.get("n_agents", 1),
              n_appended_obs=spec.get("n_appended_obs", 0),
              conv_layers=spec.get("conv_layers", ()),
              shared_noise=spec.get("shared_noise", False),
              state_upper=tuple(spec.get("state_upper", ())),
              state_lower=tuple(spec.get("state_lower", ())))
    if spec.get("discrete_values"):
        kw["discrete_values"] = spec["discrete_values"]
    else:
        if spec.get("bounded") is not None:
            kw["bounded"] = spec["bounded"]
            kw["upper_action"] = spec["upper"]
            kw["lower_action"] = spec["lower"]
    if spec.get("observable") is not None:
        kw["observable"] = spec["observable"]
    return MDPSpec(**kw)


def spec_to_mdps(spec: dict):
    """All learner MDPs of an env spec: one per agent when
    different_mdps, else a single shared one (Worker::getLearnerID,
    Worker.cpp:188: learnerID = localID iff nLearners > 1)."""
    if spec.get("different_mdps"):
        return [spec_to_mdp(spec, a) for a in range(spec["n_agents"])]
    return [spec_to_mdp(spec)]

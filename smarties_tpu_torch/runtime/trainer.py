"""Host-side training driver: pacing, warmup, eval, logging, checkpointing.

Port of smarties_tpu/runtime/trainer.py (reference runtime:
Core/Worker.cpp:53-142 runTraining, Learner::blockDataAcquisition /
blockGradientUpdates, Learner.cpp:102-123).
The host loop alternates rollout chunks over all vectorized envs with
chunks of gradient steps, paced by the obsPerStep invariant, or runs the
fused cycle (one env sweep, the at-ingest Retrace sweep, n_envs /
obsPerStep gradient steps). An on-policy learner (PPO) runs the horizon
cycle instead (PPO.cpp:44-115): fill the horizon with fresh data, its
epochs of minibatch updates, one statistics refresh, clear the replay.
That loop reads the stored-step count back once per rollout chunk, as
the JAX package's does; it is outside any fused cycle.

THE COMPILED PROGRAMS (`graphs=`, runtime/graphs.py). The JAX package
jits its programs; eagerly, a "program" is a Python loop issuing CUDA
kernels on the current stream. On a card, without a mesh, for a learner
that is `capturable` (every off-policy learner with a feed-forward net:
V-RACER, RACER, RACER-discrete, DQN, NAF, DPG and MixedPG, under any
sampler; the V-RACER family with a recurrent net too, its truncated-BPTT
step and the acting carry that the sweep threads; not PPO, ACER,
RACER-ES, or DQN, NAF and DPG with a recurrent net), the Trainer
captures two kinds of CUDA graph and replays them: the env sweep (n_roll
sweeps with their commits, then the at-ingest K1 sweep; one graph per
n_roll) and one grad step, which writes its metrics into a row of static
[rows] buffers through a device counter. On uniform minibatches the step
reads its (ep, t) row of the chunk's presampled indices: a chunk
presamples eagerly (the same draw as `train_chunk`), copies the indices
into the static buffer and replays the step graph once per step. Under
a prioritized sampler (PERrank, PERerr, PERseq) the step draws its
minibatch inside the graph from `gen_batch`, which the graph registers,
as the JAX package's in-step draw (`_train_scan`'s second body).
`train()`'s chunks replay the same graphs. The refresh,
initialize_stats and restore stay eager and write into the captured
storage (tree_copy_), never rebinding it. Logs and metrics are copied
out of the graphs' buffers after each replay. `graphs=False` runs the
eager loops on the card (jax.disable_jit's counterpart); on the CPU
`graphs=True` runs the static-buffer form uncaptured (the tests).
Pacing reads only host counters; no cycle reads a device value back
(no .item(), .cpu() or bool(tensor) in one_step, train_step, the ingest
sweep or the refresh), so the host runs ahead of the card. Logs and
metrics stay on the device until log time.

Randomness comes from explicit torch.Generators on the device: one for
env resets, one for acting noise, one for minibatch draws and one for
evaluation episodes (their starts and their acting), so that an
evaluation between cycles leaves training as it was, as the JAX
package's split of its host key does; parameters are initialised from
a CPU generator so that they do not depend on the device. All four
derive from cfg.randSeed.

THE LEARNER MESH (`mesh=`, parallel/mesh.py; the reference's
--nLearners K MPI ranks, the JAX package's "learners" mesh axis): one
process per rank, each running this host loop on its own n_envs / K
lanes and n_slots / K replay slots, with replicated parameters and
optimizer state. Each rank's env, acting and batch generators derive
from SeedSequence([randSeed, rank]); the parameters come from the same
CPU generator on every rank, so they start identical, and stay so: the
gradient is summed across ranks before each optimizer step. Every host
decision that reads the replay (the warmup loop, the one-time start
check, the PPO horizon fill) reads a count summed across ranks, and the
refresh, log and save cadences follow host counters that every rank
shares, so all ranks issue the same collectives in the same order.
n_env_steps counts the lanes of all ranks. The refresh first balances
episodes among the ranks (rebalance_shards); K1 runs on each rank's own
slots. Rank 0 writes the run directory: the episode logs of every lane
(gathered, lane rank * n_envs / K + lane), the status line and one
checkpoint.pt in the single-rank layout, which restore splits by rank.
log_status and save are collectives: call them on every rank, and give
every rank the same run_dir.
train_fused hands over to train() under a mesh, as in the JAX package.

Logs as the JAX trainer writes them into a run directory:
agent_00_rank00_cumulative_rewards.dat, with obs_log the raw observation
stream agent_00_rank00_obs.raw (f32 rows [lane, status, state...,
reward]), and at each log_status the gradient moments grads_rank00.raw
(f32 rows [grad_step, grad_norm, grad_max]). log_status(full=True) adds
the replay's stats table, the importance-weight histogram and the phase
profiler's table (utils/profiler.py: ROLL, TRAIN, REFRESH and HOST timed
by CUDA events on the card, read only there). `profiler.trace()` turns
on its span records: besides the four phases, PRESAMPLE, STEP (one per
step replay) and METRICS inside TRAIN and LOGS inside ROLL, and the
phases of a V-RACER / RACER step, stamped on the card by a second step
graph (algos/vracer.py: a conv stack's and a recurrent window's phases
among them); `profiler.export_chrome_trace` writes them.

Left out of the JAX trainer: the TPU-worker crash retry of train_fused,
SMT_PACK_STATES and the single-controller shard addressing
(_host_local), whose counterpart is the gather to rank 0.
"""
from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from smarties_tpu_torch.algos.base import local_batch, presample_uniform
from smarties_tpu_torch.core.mdp import MDPSpec
from smarties_tpu_torch.models.net import tree_copy_, tree_map
from smarties_tpu_torch.parallel import mesh as pm
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.replay.collector import (InProgress, RolloutCarry,
                                                 RolloutGens,
                                                 init_inprogress,
                                                 make_rollout_chunk)
from smarties_tpu_torch.ops.stamp import stamp_
from smarties_tpu_torch.runtime import graphs as cg
from smarties_tpu_torch.utils.config import HyperParameters
from smarties_tpu_torch.utils.profiler import Profiler


def _seeds(seed, n: int):
    """n independent 63-bit seeds derived from one integer seed (or a
    list of integers: SeedSequence's entropy)."""
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


def _inprog_lane_dim(x) -> int:
    """The lane axis of an InProgress field: [L1, V, ...] buffers, [V]
    cursors and returns."""
    return 1 if x.dim() >= 2 else 0


def _named_tensors(tree, name=""):
    """(dotted name, tensor) of every tensor of a tree of named tuples,
    dataclasses, dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [(name, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    elif hasattr(tree, "__dataclass_fields__"):
        items = ((f, getattr(tree, f)) for f in tree.__dataclass_fields__)
    else:
        return []
    return [leaf for k, v in items
            for leaf in _named_tensors(v, f"{name}.{k}" if name else str(k))]


def _bytes_of(x: torch.Tensor) -> torch.Tensor:
    """The storage byte offsets that tensor x covers, on the host."""
    size = x.element_size()
    el = torch.arange(x.untyped_storage().nbytes() // size).as_strided(
        x.shape, x.stride(), x.storage_offset())
    return (el.reshape(-1, 1) * size + torch.arange(size)).reshape(-1)


def refuse_shared_fields(env_module, state):
    """Raise if two tensors of an env's initial state share memory. The
    rollout writes the state back into these tensors field by field
    (replay/collector.py, models/net.py::tree_copy_), so the last field
    copied would overwrite the other. Views of one storage that cover
    distinct elements pass. Checked once, where the Trainer builds the
    state."""
    leaves = _named_tensors(state)
    for i, (a, x) in enumerate(leaves):
        for b, y in leaves[i + 1:]:
            if (x.untyped_storage().data_ptr()
                    != y.untyped_storage().data_ptr()):
                continue
            if bool(torch.isin(_bytes_of(x), _bytes_of(y)).any()):
                env = getattr(env_module, "__name__", repr(env_module))
                raise ValueError(
                    f"env {env}: the initial state's fields {a!r} and {b!r} "
                    f"share memory; the rollout copies the state back field "
                    f"by field, so one would overwrite the other. Give each "
                    f"field a tensor of its own")


def set_precision():
    """The contractions as the JAX package computes them, for every entry
    point: f32 products and convolutions without TF32, and bf16 GEMMs
    (nnBf16) that keep f32 accumulation in cuBLAS's split-K reduction.
    Sets nothing else."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def checked_device(device) -> torch.device:
    """The torch.device of `device`, which is required; asking for a card
    where CUDA is not available raises (nothing falls back to the CPU)."""
    if device is None:
        raise ValueError("an explicit device is required")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was asked for, but CUDA is not "
            f"available here; pass the CPU explicitly (device \"cpu\", "
            f"--device cpu) to run there")
    return dev


def can_presample(algo, cfg: HyperParameters, mesh=None) -> bool:
    """Indices can be drawn for a whole chunk up front when the sampler
    is uniform and the learner allows it (a `presample` attribute or a
    `presample_fn` of its own), as in the JAX package; the prioritized
    samplers depend on the TD errors each step writes and draw inside
    the step, as does a learner that opts out (RACER-ES). Under a mesh
    only `presample` counts (the JAX package's sharded chunk,
    parallel/mesh.py:91-92): ACER draws inside each step there."""
    return ((getattr(algo, "presample", False)
             or (mesh is None and hasattr(algo, "presample_fn")))
            and cfg.dataSamplingAlgo in ("uniform", "default"))


def presample_chunk(algo, cfg: HyperParameters, gen: torch.Generator,
                    rs: rb.ReplayState, n: int, mesh=None):
    """A chunk's (ep [n, B], t [n, B]) indices drawn up front: the
    learner's `presample_fn`, else uniform (under a mesh always uniform,
    batchSize // K per rank)."""
    fn = (presample_uniform if mesh is not None
          else getattr(algo, "presample_fn", presample_uniform))
    return fn(gen, rs, local_batch(cfg, mesh), n)


def train_chunk(algo, cfg: HyperParameters, params, opt_state,
                rs: rb.ReplayState, gen: torch.Generator, n: int,
                pre=None, mesh=None):
    """n gradient steps -> (params, opt_state, rs, metrics stacked [n]
    per key, on the device). The indices are drawn up front
    (`presample_chunk`) when the learner can presample, else by each
    step itself. pre: the chunk's (ep [n, B], t [n, B]) indices, given
    instead of drawn (a test's pinned samples). The Trainer's eager path
    and the Engine's learners share this chunk. mesh: the learner rank's
    mesh; each rank draws batchSize // K."""
    if pre is None and can_presample(algo, cfg, mesh):
        pre = presample_chunk(algo, cfg, gen, rs, n, mesh)
    ms = []
    for i in range(n):
        params, opt_state, rs, m = algo.train_step(
            params, opt_state, rs, gen=gen,
            sample_override=None if pre is None else (pre[0][i], pre[1][i]),
            mesh=mesh)
        ms.append(m)
    return params, opt_state, rs, {k: torch.stack([m[k] for m in ms])
                                   for k in ms[0]}


class Trainer:
    def __init__(self, env_module, mdp: MDPSpec, cfg: HyperParameters,
                 n_envs: int = 64, n_slots: Optional[int] = None,
                 max_len: int = 512, *, device, run_dir: Optional[str] = None,
                 algo_cls=None, state_dtype=None, obs_log: bool = False,
                 mesh: Optional[pm.LearnerMesh] = None,
                 graphs: Optional[bool] = None):
        """device: where every tensor lives ("cuda", "cuda:1", "cpu"). It
        is required: nothing picks the CPU when a card is missing.
        state_dtype: storage type of the raw states in the replay and the
        in-progress episodes (default f32; torch.uint8 for pixels).
        obs_log: write the raw observation stream into run_dir (the
        launcher's --logAllSamples).
        mesh: this process's learner rank (parallel/mesh.py). n_envs and
        n_slots are the totals over all ranks and must divide by the
        rank count; this rank holds n_envs / K lanes and n_slots / K
        slots.
        graphs: run the env sweep and the grad step as CUDA graphs
        (runtime/graphs.py; the module docstring). None, the default,
        captures on a card without a mesh when the learner is
        `capturable` (the off-policy learners with a feed-forward net,
        under any sampler, and the V-RACER family with a recurrent one);
        False runs the eager loops (on the card: the counterpart of
        jax.disable_jit, to hold the two against each other); True asks
        for the graphs and raises where the learner or the mesh does not
        allow them (PPO, ACER, RACER-ES, DQN, NAF and DPG with a
        recurrent net, a mesh), and on the CPU runs their static-buffer
        form uncaptured."""
        # the learner first: one the port lacks is reported before any
        # settings check
        if algo_cls is None:
            from smarties_tpu_torch.algos.registry import make_learner
            self.algo = make_learner(mdp, cfg)
        else:
            self.algo = algo_cls(mdp, cfg)
        cfg.check()
        set_precision()
        self.device = checked_device(device)
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
        self.mesh = mesh
        K, rank = (mesh.size, mesh.rank) if mesh is not None else (1, 0)
        if n_envs % K or n_slots % K:
            raise ValueError(
                f"{K} learner ranks must divide the env lanes ({n_envs}) "
                f"and the replay slots ({n_slots})")
        # this rank's share (the totals without a mesh)
        self.n_local_envs, self.n_local_slots = n_envs // K, n_slots // K
        capturable = mesh is None and self.algo.capturable
        if graphs and not capturable:
            raise ValueError(
                f"graphs=True: learner {cfg.learner!r} with these settings "
                f"(nnType {cfg.nnType!r}, dataSamplingAlgo "
                f"{cfg.dataSamplingAlgo!r}{', a mesh' if mesh else ''}) "
                f"has no captured step")
        self.graphs = (self.device.type == "cuda" and capturable
                       if graphs is None else graphs)
        self._sweep_graphs = {}       # n_roll -> graphs.Graph
        # pinned (ep, t) rows? -> graphs.Graph; (pinned, "traced") -> the
        # step graph that stamps its phases
        self._step_graphs = {}
        # (rows, row counter, metric rows by key, static (ep, t) rows)
        self._step_rows = None
        self._stamp_rows = None       # the traced step's [rows, stamps]
        self._stamp_counters = {}     # and what it counts a replay
        self.is_coordinator = rank == 0
        self.run_dir = run_dir
        self._rew_file = self._obs_file = self._grads_file = None
        self.obs_log = obs_log and run_dir is not None
        if run_dir and self.is_coordinator:
            os.makedirs(run_dir, exist_ok=True)
            self._rew_file = open(os.path.join(
                run_dir, "agent_00_rank00_cumulative_rewards.dat"), "a")
            # the raw observation stream and the gradient-moment dump, in
            # the formats of the Engine and the plot scripts (Agent::
            # writeData, StatsTracker's grads_*.raw)
            if self.obs_log:
                self._obs_file = open(os.path.join(
                    run_dir, "agent_00_rank00_obs.raw"), "ab")
            self._grads_file = open(os.path.join(
                run_dir, "grads_rank00.raw"), "ab")

        s_init, s_env, s_act, s_batch, s_eval = _seeds(cfg.randSeed, 5)
        if mesh is not None:
            # the same parameters on every rank; its own streams per rank
            s_env, s_act, s_batch, s_eval = _seeds([cfg.randSeed, rank], 4)
        self.params, self.opt_state = self.algo.init(
            torch.Generator().manual_seed(s_init), self.device)

        def dev_gen(s):
            return torch.Generator(device=self.device).manual_seed(s)

        self.gen_env, self.gen_act, self.gen_batch, self.gen_eval = (
            dev_gen(s_env), dev_gen(s_act), dev_gen(s_batch),
            dev_gen(s_eval))

        sdt = state_dtype or torch.float32
        rs = rb.init_replay(self.n_local_slots, max_len,
                            mdp.dim_state_observed,
                            mdp.dim_action, mdp.dim_policy,
                            cfg.clipImpWeight, mu_init=rb.safe_mu(mdp),
                            device=self.device, state_dtype=sdt)
        ip = init_inprogress(self.n_local_envs, max_len,
                             mdp.dim_state_observed, mdp.dim_action,
                             mdp.dim_policy, device=self.device,
                             state_dtype=sdt)
        env_state = env_module.init(self.gen_env, self.n_local_envs,
                                    self.device)
        refuse_shared_fields(env_module, env_state)
        self.carry = RolloutCarry(rs, ip, env_state,
                                  RolloutGens(self.gen_act, self.gen_env),
                                  self._init_rnn(self.n_local_envs))

        act_fn = self.algo.make_act_fn(train=cfg.bTrain)
        # on-policy (PPO) fills a horizon, then clears: the commit cap gets
        # slack so that commit-time pruning never drops fresh horizon data.
        # Each rank holds its share of the cap (the reference splits
        # maxTotObsNum across learner ranks, defineDistributedLearning)
        self.on_policy = self.algo.on_policy
        commit_cap = cfg.maxTotObsNum * (4 if self.on_policy else 1) // K
        self._rollout = make_rollout_chunk(
            env_module, mdp, act_fn, commit_cap, cfg.ERoldSeqFilter,
            record_obs=self.obs_log)
        mode = self.algo.returns_mode
        # the three return-sweep callables (K1 runs inside each, on this
        # rank's slots)
        self._fix_returns = lambda r: rb.refresh_new_returns(
            r, cfg.gamma, cfg.lambda_, mode)
        if mesh is None:
            self._refresh = self.algo.refresh
            self._init_stats = self.algo.initialize_stats
        else:
            def refresh(r, n_grad):
                # balance the shards first (mesh.py:152-160 of the JAX
                # package), with the global capacity as it passes it
                r = rb.rebalance_shards(r, mesh, k_max=8,
                                        max_tot_obs=cfg.maxTotObsNum,
                                        filter_algo=cfg.ERoldSeqFilter)
                return self.algo.refresh(r, n_grad, mesh=mesh)

            self._refresh = refresh
            self._init_stats = lambda r: self.algo.initialize_stats(
                r, mesh=mesh)
        # phase profiler (Utils/Profiler; ROLL / TRAIN / REFRESH / HOST)
        self.profiler = Profiler(self.device)

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

    def _sweep(self, n: int):
        """n env sweeps with their commits, then the at-ingest Retrace of
        the episodes committed in them -> the sweeps' logs, on the
        device. With graphs: one captured program per n, whose logs are
        copied out."""
        if not self.graphs:
            self.carry, logs = self._rollout(self.params, self.carry, n)
            self.carry = self.carry._replace(
                replay=self._fix_returns(self.carry.replay))
            return logs
        g = self._sweep_graphs.get(n)
        if g is None:
            def program(carry):
                carry, logs = self._rollout(self.params, carry, n)
                return carry._replace(
                    replay=self._fix_returns(carry.replay)), logs

            g = self._sweep_graphs[n] = cg.Graph(
                program, self.carry, device=self.device,
                generators=(self.gen_act, self.gen_env))
        out = g()
        with self.profiler.span("LOGS"):
            return tuple(x.clone() for x in out)

    def _update_replay(self, fn, *args):
        """An eager update of the carried replay (refresh,
        initialize_stats), its result kept in the replay's own storage,
        which the graphs read."""
        tree_copy_(self.carry.replay, fn(self.carry.replay, *args))

    def graph_pool_bytes(self) -> int:
        """Device memory reserved by the private pools of the captured
        programs."""
        gs = [*self._sweep_graphs.values(), *self._step_graphs.values()]
        return sum(g.pool_bytes for g in gs)

    def _roll(self, n_steps: int):
        with self.profiler("ROLL"):
            logs = self._sweep(n_steps)
        self.n_env_steps += n_steps * self.n_envs
        # deferred transfer; counters captured now so the rows keep the
        # grad/env-step columns of their episodes (MemoryBuffer.cpp:491)
        self._pending_logs.append((logs, self.n_grad_steps,
                                   self.n_env_steps))
        if len(self._pending_logs) >= self.log_flush_threshold:
            self._flush_logs()

    def _global_counts(self, *counts) -> list:
        """Host ints of 0-d device counts, summed over the ranks under a
        mesh (one collective: every rank calls this at the same point).
        A synchronisation."""
        v = torch.stack([c.to(torch.int64) for c in counts])
        if self.mesh is not None:
            pm.psum_(self.mesh, v)
        return v.tolist()

    def _gather_lanes(self, pending):
        """The pending logs with every rank's lanes, on rank 0 (lane
        rank * n_local + lane, the JAX mesh's global order); [] on the
        other ranks. Each log field of all pending chunks goes in one
        all_gather."""
        n = [logs[0].shape[0] for logs, _, _ in pending]
        fields = [pm.all_gather(self.mesh, torch.cat(
            [logs[i] for logs, _, _ in pending]))
            for i in range(len(pending[0][0]))]
        if not self.is_coordinator:
            return []
        fields = [torch.cat(parts, dim=1).split(n) for parts in fields]
        return [(tuple(f[j] for f in fields), g, e)
                for j, (_, g, e) in enumerate(pending)]

    def _flush_logs(self):
        pending, self._pending_logs = self._pending_logs, []
        if not pending:
            return
        with self.profiler("HOST"):
            if self.mesh is not None:
                pending = self._gather_lanes(pending)
            for logs, g, e in pending:
                self._log_episodes(logs, g, e)

    def _log_episodes(self, logs, g=None, e=None):
        g = self.n_grad_steps if g is None else g
        e = self.n_env_steps if e is None else e
        done, length, ret = (x.cpu().numpy() for x in logs[:3])
        if self._obs_file is not None and len(logs) > 3:
            self._write_obs_rows(logs[3:])
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

    def _write_obs_rows(self, rec):
        """Append f32 rows [lane, status, state..., reward] in env-step
        order, each step's final rows after its served rows: the
        agent_*_obs.raw format of the Engine (Agent.h:259-299)."""
        obs, rew_in, status, obs_f, rew_f, status_f = (
            np.asarray(x.cpu().numpy(), np.float32) for x in rec)
        k, V = status.shape
        lane = np.broadcast_to(np.arange(V, dtype=np.float32), (k, V))
        row = np.concatenate(  # [k, V, 2 + dimS + 1]
            [lane[..., None], status[..., None], obs, rew_in[..., None]],
            axis=-1)
        row_f = np.concatenate(
            [lane[..., None], status_f[..., None], obs_f,
             rew_f[..., None]], axis=-1)
        out = []
        for i in range(k):
            out.append(row[i])
            fin = status_f[i] > 0
            if fin.any():
                out.append(row_f[i][fin])
        self._obs_file.write(np.concatenate(out).tobytes())

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
            while True:
                stored, in_flight = self._global_counts(
                    self.replay.n_stored_steps(),
                    torch.sum(self.carry.inprog.t))
                if stored >= self.n_obs_b4_start:
                    break
                remaining = self.n_obs_b4_start - stored - in_flight
                n = max(1, min(chunk, int(np.ceil(
                    max(remaining, self.n_envs) / self.n_envs))))
                n = chunk if (n >= chunk or not adaptive) else 1
                self._roll(n)
        self._update_replay(self._init_stats)
        self._initialized = True

    # ------------------------------------------------------------------
    def _keep_going(self, target: int, t0: float, max_wall_s: float) -> bool:
        """The training loops' condition. Under a mesh a wall-clock limit
        is decided by all ranks together (each rank's clock differs; a
        rank that stopped alone would leave the others waiting)."""
        go = (self.n_grad_steps < target
              and time.time() - t0 < max_wall_s)
        if self.mesh is not None and max_wall_s != float("inf"):
            n_go, = self._global_counts(torch.full(
                (), int(go), dtype=torch.int64, device=self.device))
            go = n_go == self.mesh.size
        return go

    def _n_loc_train_steps(self) -> int:
        return self.n_env_steps - self.n_obs_b4_start

    def block_data(self) -> bool:
        """Learner::blockDataAcquisition (Learner.cpp:102-113). The
        one-time start condition reads the stored-step count back until
        it holds, then is cached."""
        if not self._min_stored_reached:
            stored, = self._global_counts(self.replay.n_stored_steps())
            if stored < self.n_obs_b4_start:
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
        return can_presample(self.algo, self.cfg)

    def _train_chunk(self, n: int, pre=None):
        """n gradient steps on the carried replay; metrics stacked [n] per
        key, on the device. Eagerly `train_chunk`; with graphs the same
        draw of the chunk's indices where the learner can presample (or
        `pre`, pinned (ep, t) [n, B]) and one replay per step of the step
        graph that reads them, else one replay per step of the step graph
        that draws its own minibatch from `gen_batch` (the prioritized
        samplers). The static buffers hold max(n_envs / obsPerStep, 100)
        rows, the fused cycle's and train()'s chunks: a longer chunk runs
        in pieces of that many. While the profiler traces, the chunk's
        PRESAMPLE, STEP (each replay) and METRICS spans are recorded, and
        a learner with `step_phases` replays a second step graph that
        stamps them (the plain graph keeps its nodes)."""
        if not self.graphs:
            self.params, self.opt_state, rs, metrics = train_chunk(
                self.algo, self.cfg, self.params, self.opt_state,
                self.carry.replay, self.gen_batch, n, pre=pre,
                mesh=self.mesh)
            self.carry = self.carry._replace(replay=rs)
            return metrics
        prof = self.profiler
        if pre is None and self._can_presample:
            with prof.span("PRESAMPLE"):
                pre = presample_chunk(self.algo, self.cfg, self.gen_batch,
                                      self.replay, n)
        pinned = pre is not None
        traced = prof.tracing and bool(self.algo.step_phases)
        gkey = (pinned, "traced") if traced else pinned
        graph = self._step_graphs.get(gkey)
        if graph is None:
            graph = self._step_graphs[gkey] = self._build_step_graph(
                pinned, traced)
        rows, i, m_rows, pins = self._step_rows
        pieces = []
        for lo in range(0, n, rows):
            k = min(n - lo, rows)
            if pinned:
                with prof.span("PRESAMPLE"):
                    pins[0][:k].copy_(pre[0][lo:lo + k])
                    pins[1][:k].copy_(pre[1][lo:lo + k])
            i.zero_()
            if prof.tracing:
                steps = []
                for _ in range(k):
                    steps.append(prof.begin("STEP"))
                    graph()
                    prof.end(steps[-1])
            else:
                for _ in range(k):
                    graph()
            with prof.span("METRICS"):
                pieces.append({key: b[:k].clone()
                               for key, b in m_rows.items()})
                if traced:
                    prof.add_stamps(steps, self.algo.step_phases,
                                    self._stamp_rows[:k].clone(),
                                    self._stamp_counters)
        if len(pieces) == 1:
            return pieces[0]
        return {key: torch.cat([p[key] for p in pieces]) for key in pieces[0]}

    def _build_step_graph(self, pinned: bool, traced: bool = False):
        """The captured grad step: the learner's train step on row i of
        the static (ep, t) buffers [rows, batchSize] (`pinned`), or on its
        own draw from `gen_batch`, which the graph then registers; its
        metrics into row i of [rows] buffers (made at the first, eager
        call); then i + 1. Every form shares the buffers and the counter.
        `traced`: the step also stamps the start, the end of each of the
        learner's `step_phases` and the end of the metric copies into row
        i of the static [rows, len(step_phases) + 1] stamp buffer
        (ops/stamp.py: the card's timer, in stream order), and the
        counters the step reports as it is captured (the conv stack's
        multiply-adds, or a BPTT window's cells and multiply-adds, a
        replay) into `_stamp_counters`."""
        dev = self.device
        if self._step_rows is None:
            rows = max(int(round(self.n_envs / self.cfg.obsPerStep)), 100)
            self._step_rows = (
                rows, torch.zeros((1,), dtype=torch.int64, device=dev), {},
                tuple(torch.zeros((rows, self.cfg.batchSize),
                                  dtype=torch.int32, device=dev)
                      for _ in range(2)))
        rows, i, m_rows, pins = self._step_rows
        stamp, kw = None, {}
        if traced:
            phases = self.algo.step_phases
            if self._stamp_rows is None:
                self._stamp_rows = torch.zeros((rows, len(phases) + 1),
                                               dtype=torch.int64, device=dev)
            buf = self._stamp_rows

            def stamp(name):
                stamp_(buf, i, phases.index(name) + 1)

            stamp.counters = self._stamp_counters
            kw = {"stamp": stamp}

        def program(state):
            params, opt_state, rs = state
            if stamp is not None:
                stamp_(buf, i, 0)
            row = (tuple(x.index_select(0, i)[0] for x in pins) if pinned
                   else None)
            params, opt_state, rs, m = self.algo.train_step(
                params, opt_state, rs, gen=self.gen_batch,
                sample_override=row, **kw)
            for key, v in m.items():
                if key not in m_rows:
                    m_rows[key] = torch.empty((rows,) + tuple(v.shape),
                                              dtype=v.dtype, device=dev)
                m_rows[key].index_copy_(0, i, v[None])
            if stamp is not None:
                stamp(phases[-1])
            i.add_(1)
            return (params, opt_state, rs), None

        return cg.Graph(
            program, (self.params, self.opt_state, self.carry.replay),
            device=dev, generators=() if pinned else (self.gen_batch,))

    def _fused_cycle(self, n_roll: int, n_train: int):
        """[n_roll env sweeps + at-ingest returns + n_train grad steps]:
        the JAX package's fused program, as two replayed graphs with
        graphs (the sweep's, and the step's once per step). The ingest
        sweep runs K1 here too (the JAX package could not co-compile its
        kernel with lax.scan and used an associative scan instead)."""
        self.profiler.cycle += 1
        with self.profiler("ROLL"):
            logs = self._sweep(n_roll)
        with self.profiler("TRAIN"):
            return self._train_chunk(n_train), logs

    def train_fused(self, n_grad_steps: int, log_every: int = 1000,
                    max_wall_s: float = float("inf"), flush: bool = True):
        """Steady-state training with fused cycles: each cycle rolls one
        env sweep (n_envs observations) and runs n_envs/obsPerStep grad
        steps, keeping the obsPerStep invariant exactly. The 1000-step
        refresh runs between cycles at the nearest boundary. An on-policy
        learner has no such cycle and takes train()'s horizon loop, as in
        the JAX package; every other learner keeps the cycle, with each
        step drawing its own minibatch where it cannot presample (the
        prioritized samplers, RACER-ES). Under a mesh it hands over to
        train(), as the JAX package does."""
        if self.on_policy or self.mesh is not None:
            return self.train(n_grad_steps, log_every, max_wall_s)
        if not self._initialized:
            self.warmup()
        n_train = max(1, int(round(self.n_envs / self.cfg.obsPerStep)))
        target = self.n_grad_steps + n_grad_steps
        t0 = time.time()
        while self._keep_going(target, t0, max_wall_s):
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
                with self.profiler("REFRESH"):
                    self._update_replay(self._refresh,
                                        float(self.n_grad_steps))
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
        while self._keep_going(target, t0, max_wall_s):
            self.profiler.cycle += 1
            allowed = int(self._n_loc_train_steps() / self.cfg.obsPerStep
                          ) - self.n_grad_steps
            allowed = min(allowed, target - self.n_grad_steps)
            n_tr = Q if allowed >= Q else max(0, allowed)
            if n_tr > 0:
                with self.profiler("TRAIN"):
                    self._last_metrics = self._train_chunk(n_tr)
                self.n_grad_steps += n_tr
                if self.cfg.debugNaN:
                    self._check_nan()
            if self.n_grad_steps // 1000 > self._last_refresh // 1000:
                self._last_refresh = self.n_grad_steps
                with self.profiler("REFRESH"):
                    self._update_replay(self._refresh,
                                        float(self.n_grad_steps))
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
        while self._keep_going(target, t0, max_wall_s):
            # fill the horizon with fresh on-policy data: one read of the
            # (global) stored-step count per rollout chunk
            while self._global_counts(self.replay.n_stored_steps())[0] \
                    < horizon:
                self._roll(roll_n)
            if not self._initialized:
                self._update_replay(self._init_stats)
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
            self._update_replay(self._refresh, float(self.n_grad_steps))
            if (self.n_grad_steps - self._last_log) >= log_every:
                self._last_log = self.n_grad_steps
                self.log_status()
            # epoch over: discard the data (PPO.cpp:105-112)
            self._update_replay(rb.clear_all)
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

    def log_status(self, full: bool = False):
        """The status line; the gradient moments into grads_rank00.raw;
        with `full` the stats table, the importance-weight histogram and
        the profiler's table. Reads the device: a log-time call only.
        Under a mesh every rank calls it (the episode logs and the replay
        counts are gathered) and rank 0 prints; the stats table and the
        histogram are of rank 0's shard."""
        self._flush_logs()
        self._check_nan()
        rs = self.replay
        n_eps, n_obs = self._global_counts(rs.n_stored_eps(),
                                           rs.n_stored_steps())
        if not self.is_coordinator:
            return
        avg_r = (np.mean(self._ep_returns[-100:])
                 if self._ep_returns else float("nan"))
        m = self._last_metrics
        get = lambda k: float(m[k][-1]) if k in m else float("nan")
        print(f"step {self.n_grad_steps:>8d} | envstep {self.n_env_steps:>9d}"
              f" | avgR {avg_r:8.2f} | beta {float(rs.beta):.3f}"
              f" | dkl {get('avg_dkl'):.4f} | rmse {get('rmse'):.3f}"
              f" | nEp {n_eps} | nObs {n_obs}", flush=True)
        if self._grads_file is not None and "grad_norm" in m:
            # f32 rows [grad_step, grad_norm, grad_max]
            self._grads_file.write(np.asarray(
                [self.n_grad_steps, get("grad_norm"), get("grad_max")],
                np.float32).tobytes())
            self._grads_file.flush()
        if full:
            from smarties_tpu_torch.utils.stats import (iw_histogram,
                                                        stats_header,
                                                        stats_row)
            print(stats_header())
            print(stats_row(rs, self.n_grad_steps))
            print(iw_histogram(rs))
            print("profiler:\n" + self.profiler.table(), flush=True)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, n_episodes: int = 10, max_steps: int = 1000,
                 materialize: bool = True):
        """Deterministic-policy evaluation episodes (bTrain=0 serving path,
        Worker.cpp:91-111). Start states and acting draws come from the
        evaluation's own generator (`gen_eval`), so an evaluation leaves
        the training streams untouched.

        materialize=False returns the device tensor of returns without
        reading it back (the caller checks it)."""
        act = self.algo.make_act_fn(False)
        env, mdp = self.env, self.mdp
        rs = self.replay
        es = env.init(self.gen_eval, n_episodes, self.device)
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
            a, _, _, _, rnn = act(self.params, obs_std, self.gen_eval, rnn)
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
    def _gather(self, x, dim: int):
        """Every rank's x concatenated along `dim` (x itself without a
        mesh): the single-rank layout of a sharded tensor."""
        if self.mesh is None:
            return x
        return torch.cat(pm.all_gather(self.mesh, x), dim=dim).cpu()

    def _split(self, x, dim: int):
        """This rank's block of a single-rank-layout tensor along `dim`
        (the inverse of _gather)."""
        if self.mesh is None:
            return x
        return x.chunk(self.mesh.size, dim)[self.mesh.rank].contiguous()

    def save(self, path: str):
        """Checkpoint params/opt/replay/rollout state/acting carry/
        generators/counters with torch.save (the fields of the JAX
        package's pickle; the replay in the port's per-field layout), and
        flush cumulative_rewards.dat. Loadable with weights_only=True:
        named tuples are stored as plain dicts and lists.

        Under a mesh every rank calls it: the replay slots, the lanes'
        in-progress episodes, env states and acting carries are gathered
        into the single-rank layout (rank-major), the replicated fields
        are rank 0's, and rank 0 writes the one file. The generators are
        rank 0's under "gens" and every rank's under "rank_gens"."""
        self._flush_logs()
        for f in (self._rew_file, self._obs_file, self._grads_file):
            if f is not None:
                f.flush()
        rs = self.carry.replay
        gens = {k: getattr(self, "gen_" + k).get_state()
                for k in ("env", "act", "batch", "eval")}
        extra = {}
        if self.mesh is not None:
            from smarties_tpu_torch.models.convert import gather_replay
            parts = {f: pm.all_gather(self.mesh, getattr(rs, f))
                     for f in rs.__dataclass_fields__}
            rs = gather_replay([rb.ReplayState(**{
                f: p[r].cpu() for f, p in parts.items()})
                for r in range(self.mesh.size)])
            extra["rank_gens"] = [
                {k: g.cpu() for k, g in zip(gens, per_rank)}
                for per_rank in zip(*(pm.all_gather(
                    self.mesh, st.to(self.device)) for st in gens.values()))]
        ip = self.carry.inprog
        state = {
            "params": tree_map(lambda x: x.detach(), self.params),
            "opt_state": _plain(self.opt_state),
            "replay": {f: getattr(rs, f) for f in rs.__dataclass_fields__},
            "inprog": {k: self._gather(v, _inprog_lane_dim(v))
                       for k, v in ip._asdict().items()},
            "env_state": {k: self._gather(v, 0) for k, v in
                          self.carry.env_state._asdict().items()},
            "rnn": _plain(tree_map(lambda x: self._gather(x, 0),
                                   self.carry.rnn)),
            "gens": gens,
            "n_env_steps": self.n_env_steps,
            "n_grad_steps": self.n_grad_steps,
            "initialized": self._initialized,
            "cfg": self.cfg.to_dict(),
            **extra,
        }
        if not self.is_coordinator:
            return
        tmp = path + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)  # write-then-rename atomicity

    def restore(self, path: str):
        """Load a checkpoint of this configuration. Every tensor is copied
        into the storage of the one it replaces, which the graphs read:
        the params (nested {"net", "tgt"} trees included), the optimiser
        state and acting carry read in the structure of the current ones
        (AdamState, MixedPGOptState, PPOOptState; the carry's nested
        tuples, LSTM (h, c) pairs included), the replay, the in-progress
        episodes and the env state; the generators take their saved
        states.

        Under a mesh each rank takes its block of the slots and lanes, and
        the generators of its rank where the checkpoint has as many ranks
        ("rank_gens"); a single process takes "gens". Otherwise the ranks
        keep their own generators."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        n_saved = state["replay"]["slot_len"].shape[0]
        if n_saved != self.n_slots:
            raise ValueError(f"the checkpoint holds {n_saved} replay slots, "
                             f"this trainer {self.n_slots}")
        tree_copy_(self.params, state["params"])
        tree_copy_(self.opt_state,
                   _restructure(self.opt_state, state["opt_state"]))
        dims = pm.shard_fields(self.carry.replay)
        rs = rb.ReplayState(**{
            f: self._split(x, dims[f]) if f in dims else x
            for f, x in state["replay"].items()})
        if self.mesh is not None:
            rs = rb.rebuild_sample_cache(rs)
        tree_copy_(self.carry, RolloutCarry(
            rs,
            InProgress(**{k: self._split(v, _inprog_lane_dim(v))
                          for k, v in state["inprog"].items()}),
            type(self.carry.env_state)(**{
                k: self._split(v, 0) for k, v in state["env_state"].items()}),
            self.carry.gens,
            tree_map(lambda x: self._split(x, 0),
                     _restructure(self.carry.rnn, state["rnn"]))))
        K = self.mesh.size if self.mesh is not None else 1
        gens = state["gens"] if K == 1 else None
        if self.mesh is not None and len(state.get("rank_gens", ())) == K:
            gens = state["rank_gens"][self.mesh.rank]
        for k, st in (gens or {}).items():
            getattr(self, "gen_" + k).set_state(st.cpu())
        self.n_env_steps = state["n_env_steps"]
        self.n_grad_steps = state["n_grad_steps"]
        self._initialized = state["initialized"]

"""The learner mesh: K learner ranks, one process each, on torch.distributed.

Port of smarties_tpu/parallel/mesh.py. The JAX package shards the replay
(slot axis) and the vectorized envs (lane axis) over one "learners" mesh
axis with shard_map; the reference runs K MPI learner ranks, each owning
its env workers and replay shard (Settings/ExecutionInfo.cpp:209-374).
The port takes the reference's topology: each rank is a process that
owns n_envs / K lanes and n_slots / K slots and holds replicated
parameters and optimizer state. The collectives that shard_map issues
become the functions below, on tensors:

    psum -> psum_      pmax -> pmax_      pmean -> pmean
    ppermute over the ring [(i, (i+1) % K)] -> ring_shift
    psum of a gradient pytree -> psum_tree_ (ONE flat buffer)

`axis_index` is `mesh.rank`; `fold_in(key, axis_index)` becomes each
rank's own generator (runtime/trainer.py seeds them from
SeedSequence([randSeed, rank])).

EVERY RANK ISSUES THE SAME COLLECTIVES IN THE SAME ORDER, or a rank
waits until the process group's timeout. The learners call them at
fixed points of a step; the Trainer takes every host decision from an
all-reduced count or a host counter that all ranks share.

With gloo, a collective on a CUDA tensor copies through the host and
synchronises the stream on every call; NCCL enqueues it on the stream.
`LearnerMesh.counts` counts the collectives by kind (the chip smoke
reads the count per grad step).

A ring sum adds in another order than XLA's psum, so results agree with
the JAX package's to a tolerance, not bit for bit (bit for bit at K = 2,
where each sum has two terms).
"""
from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist

# the per-slot vectors of the port's ReplayState (samp_csum / samp_start
# is each shard's own sampling cache, as samp_cl in the JAX package's
# replay_pspec); its time-major step fields ("*_tm") are per-slot too
SLOT_VECTORS = ("slot_len", "slot_id", "slot_term", "far_count",
                "qret_stale", "v_trunc", "samp_csum", "samp_start")


@dataclasses.dataclass
class LearnerMesh:
    """This process's place among the learner ranks: its `rank` of
    `size`, the `device` its tensors live on and the process `group`
    (None: the default group). `counts` tallies the collectives issued
    through this mesh, by kind."""
    rank: int
    size: int
    device: torch.device
    group: object = None
    counts: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


def make_mesh(device, group=None) -> LearnerMesh:
    """The mesh of an initialised process group (parallel/multihost.py)."""
    return LearnerMesh(dist.get_rank(group), dist.get_world_size(group),
                       torch.device(device), group)


def shard_fields(rs) -> dict:
    """{field: slot axis} of the per-slot fields of a ReplayState: dim 1
    of the time-major [L+1, E, ...] step fields, dim 0 of the per-slot
    vectors. The fields it leaves out are replicated (the analog of
    replay_pspec)."""
    return {f: 1 if f.endswith("_tm") else 0 for f in rs.__dataclass_fields__
            if f.endswith("_tm") or f in SLOT_VECTORS}


def _all_reduce_(mesh: LearnerMesh, x, op, kind: str):
    mesh.counts[kind] += 1
    dist.all_reduce(x.view(1) if x.dim() == 0 else x, op=op,
                    group=mesh.group)
    return x


def psum_(mesh: LearnerMesh, x):
    """In-place sum across ranks (jax.lax.psum); returns x."""
    return _all_reduce_(mesh, x, dist.ReduceOp.SUM, "psum")


def pmax_(mesh: LearnerMesh, x):
    """In-place maximum across ranks (jax.lax.pmax); returns x."""
    return _all_reduce_(mesh, x, dist.ReduceOp.MAX, "pmax")


def pmean(mesh: LearnerMesh, x):
    """Mean across ranks (jax.lax.pmean: the psum over K) -> new tensor."""
    return psum_(mesh, x.clone()) / mesh.size


def psum_tree_(mesh: LearnerMesh, leaves):
    """Sum a list of tensors across ranks through ONE flat buffer (one
    collective per grad step, not one per leaf), written back into the
    leaves; returns them."""
    flat = torch.cat([x.reshape(-1) for x in leaves])
    psum_(mesh, flat)
    for x, f in zip(leaves, torch.split(flat, [x.numel() for x in leaves])):
        x.copy_(f.view_as(x))
    return leaves


def all_gather(mesh: LearnerMesh, x) -> list:
    """Every rank's x (of one shape on all ranks), in rank order."""
    mesh.counts["all_gather"] += 1
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x.contiguous(), group=mesh.group)
    return out


def broadcast_(mesh: LearnerMesh, x, src: int = 0):
    """Overwrite x with rank src's, in place; returns x."""
    mesh.counts["broadcast"] += 1
    dist.broadcast(x, src=src, group=mesh.group)
    return x


def ring_shift(mesh: LearnerMesh, payload: dict) -> dict:
    """ppermute over the ring perm = [(i, (i+1) % K)]: each rank gets its
    left neighbour's payload (a dict of tensors). Built on all_gather,
    each rank keeping part (rank - 1) % K: gloo has no send/recv for CUDA
    tensors, all_gather works on both backends, and the payloads are a
    few episodes (rebalance_shards ships at most k_max)."""
    src = (mesh.rank - 1) % mesh.size
    return {k: all_gather(mesh, v)[src] for k, v in payload.items()}

"""Process-group set-up for learner ranks.

Port of smarties_tpu/parallel/multihost.py. The reference scales past
one learner with MPI ranks (ExecutionInfo MPI_Init and its topology
solver); the JAX package uses jax.distributed and one global mesh. The
port runs one process per learner rank, joined by torch.distributed:

    from smarties_tpu_torch.parallel.multihost import init_multihost
    from smarties_tpu_torch.parallel.mesh import make_mesh
    init_multihost(backend="nccl")    # under torchrun: reads its env
    mesh = make_mesh(f"cuda:{local_rank}")
    tr = Trainer(..., mesh=mesh, n_envs=K * lanes_per_rank,
                 device=mesh.device)

Every rank runs the same host loop; what each rank decides on the host
comes from all-reduced or globally counted values, so all ranks issue
the same collectives in the same order (parallel/mesh.py).
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """The backend the launcher uses for a device: "nccl" for a card,
    "gloo" for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def check_ranks(backend: str, n_ranks: int):
    """For n_ranks local ranks of one host: NCCL refuses two ranks on one
    card ("Duplicate GPU detected"), so it takes at most as many ranks as
    the host has cards."""
    if backend == "nccl" and n_ranks > torch.cuda.device_count():
        raise ValueError(
            f"{n_ranks} learner ranks on {torch.cuda.device_count()} "
            f"card(s): NCCL takes one rank per card (it refuses two ranks "
            f"on one card, 'Duplicate GPU detected'); use fewer ranks or "
            f"the gloo backend")


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   *, backend: str, timeout_s: float = 300.0):
    """dist.init_process_group with an explicit backend -> (rank,
    world_size). With no arguments it reads torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE): the analog of
    jax.distributed.initialize()'s auto-detection. timeout_s bounds
    every collective, so a rank that waits on a missing peer fails in
    that time instead of hanging."""
    kw = {}
    if world_size is not None:
        kw.update(world_size=world_size, rank=rank)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dist.get_rank(), dist.get_world_size()


def is_coordinator() -> bool:
    """Rank 0 (or a single process): the rank that writes logs and
    checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0

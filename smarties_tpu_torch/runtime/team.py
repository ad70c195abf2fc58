"""Intra-team collectives for multi-process environment applications.

The port's copy of smarties_tpu/runtime/team.py, unchanged.

Re-expresses the reference's `environment_app_comm` (P6 in SURVEY §2.9):
apps whose simulation spans several processes get an MPI communicator per
env team (Settings/ExecutionInfo.cpp:315-332) and coordinate with
Allgather/Allreduce/Bcast/Barrier (apps/cart_pole_distribEnv/cart-pole.cpp,
apps/cart_pole_distribAgent/cart-pole.cpp). There is no MPI on the TPU
host side of this rebuild; the equivalent is this tiny star-topology
collective library over multiprocessing pipes: every non-root member holds
a duplex pipe to the team's rank 0, and each collective is a gather to
rank 0 followed by a broadcast.

The pipes are created by `make_team_pipes` in the parent BEFORE forking so
each member inherits only its own ends (fork semantics identical to the
reference's Launcher fork, Core/Launcher.cpp:28-69).
"""
from __future__ import annotations

import multiprocessing as mp
from typing import List, Optional, Sequence

import numpy as np


def make_team_pipes(ctx, size: int):
    """Returns (root_ends, member_ends): root_ends[k] is rank 0's pipe to
    rank k+1; member_ends[k] is rank k+1's end. size==1 -> ([], [])."""
    root_ends, member_ends = [], []
    for _ in range(max(0, size - 1)):
        a, b = ctx.Pipe()
        root_ends.append(a)
        member_ends.append(b)
    return root_ends, member_ends


class TeamComm:
    """Per-member handle passed to `app_main(comm, team)` for apps that
    declare workers_per_env > 1 (Engine::setNworkersPerEnvironment,
    reference Engine.cpp:51-55).

    rank 0 constructs with conns=root_ends; rank k>0 with the single
    member end. All collectives are synchronous and must be called by
    every member in the same order (SPMD, like the MPI they replace).
    """

    def __init__(self, rank: int, size: int, conns):
        self.rank = int(rank)
        self.size = int(size)
        if rank == 0:
            self._to_members: Sequence = conns     # size-1 ends
            self._to_root = None
        else:
            self._to_members = ()
            self._to_root = conns

    # -- core: gather to root, then broadcast the combined list ----------
    def allgather(self, value) -> List:
        """Every rank contributes one object; all ranks receive the
        rank-ordered list (MPI_Allgather analog,
        apps/cart_pole_distribAgent/cart-pole.cpp:52-56)."""
        if self.size == 1:
            return [value]
        if self.rank == 0:
            out = [value] + [c.recv() for c in self._to_members]
            for c in self._to_members:
                c.send(out)
            return out
        self._to_root.send(value)
        return self._to_root.recv()

    def allreduce(self, value, op=None):
        """Sum (default) or custom binary-op reduction of one value per
        rank, result on all ranks (MPI_Allreduce analog)."""
        parts = self.allgather(value)
        if op is None:
            total = parts[0]
            for p in parts[1:]:
                total = total + p
            return total
        total = parts[0]
        for p in parts[1:]:
            total = op(total, p)
        return total

    def bcast(self, value=None, root: int = 0):
        """Broadcast root's value to every rank (MPI_Bcast analog; only
        root=0 is supported by the star topology)."""
        assert root == 0, "TeamComm.bcast supports root=0 only"
        out = self.allgather(value if self.rank == 0 else None)
        return out[0]

    def barrier(self):
        """MPI_Barrier analog (apps/cart_pole_distribEnv/cart-pole.cpp:40)."""
        self.allgather(None)

    # convenience for numeric state exchange
    def allgather_array(self, arr) -> np.ndarray:
        """Concatenate each rank's 1-D float array in rank order."""
        parts = self.allgather(np.asarray(arr, np.float64))
        return np.concatenate(parts)

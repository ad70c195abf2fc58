"""Synthetic inputs of a grad step's tail (algos/base.py::step_tail_), for
tests/test_torch_step_tail.py on the CPU and tests/test_torch_step_tail_
cuda.py on the card: a replay with stored and empty slots, a minibatch
gathered from it, the rows a learner computes and a gradient tree. The
values come from a CPU generator and move to the device, so both files
see the same numbers. `mesh_tails` and `mesh_rank` run a tail under a
learner mesh through step_tail_ and through the chain. This module
imports neither jax nor the JAX package."""
import dataclasses
import datetime
import os

import torch

from smarties_tpu_torch.algos import base
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import step_tail_kernel as stk
from smarties_tpu_torch.replay import buffer as rb
from smarties_tpu_torch.utils.config import HyperParameters


def cfg(**kw) -> HyperParameters:
    """Settings that reach every branch of the ReF-ER scalars at these
    sizes: a small maxTotObsNum makes learn_r large."""
    return HyperParameters(**dict(dict(batchSize=32, maxTotObsNum=200,
                                       clipImpWeight=4.0, epsAnneal=5e-3,
                                       penalTol=0.1), **kw))


def clone_replay(rs):
    return dataclasses.replace(rs, **{
        f.name: getattr(rs, f.name).clone()
        for f in dataclasses.fields(rs)})


def case(device, seed=0, E=64, max_len=16, B=32, clip=4.0, invalid=0,
         shared=0, dup=0, step=7, ep_dtype=torch.int32):
    """-> (rs, mb, rows, grads, opt_step). rows: the keyword arguments of
    step_tail_ after grads (rho, dkl, delta, value, advantage, v_next,
    is_far). The rows sample distinct stored (ep, t) but for these: the
    last `invalid` rows are invalid, the first `shared` of them at the
    (ep, t) of rows 0, 1, ..., the others in empty slots; `dup` valid
    rows after them repeat another valid row's (ep, t) with values of
    their own."""
    g = torch.Generator().manual_seed(seed)
    rs = rb.init_replay(E, max_len, 3, 1, 2, clip_imp_weight=clip)
    L1 = max_len + 1
    rs.slot_len.copy_(torch.randint(1, L1, (E,), generator=g,
                                    dtype=torch.int32))
    stored = torch.rand(E, generator=g) < 0.75
    stored[0] = True
    stored[-1] = False
    rs.slot_id.copy_(torch.where(stored, torch.arange(E, dtype=torch.int32),
                                 torch.full((E,), -1, dtype=torch.int32)))
    rs.slot_term.copy_(torch.rand(E, generator=g) < 0.5)
    for x in (rs.kl_tm, rs.delta_tm, rs.value_tm, rs.advantage_tm,
              rs.v_trunc, rs.qret_tm):
        x.copy_(torch.randn(x.shape, generator=g))
    # rho about the far-policy bounds 1/C and C
    rs.rho_tm.copy_(torch.exp(torch.randn((L1, E), generator=g) * 1.2))
    rs.far_count.copy_(rb.far_count_exact(rs))
    rs.beta.fill_(0.37)
    rs.alpha.fill_(0.61)
    rs.max_abs_error.fill_(0.8)

    # B distinct stored (ep, t), a quarter of them at a slot's last step
    # (truncated where the slot is not terminal)
    ok = torch.nonzero(stored)[:, 0].tolist()
    lens = rs.slot_len.tolist()
    last = [(e, lens[e] - 1) for e in ok]
    inner = [(e, s) for e in ok for s in range(lens[e] - 1)]
    n_last = B // 4
    pick = ([last[i] for i in torch.randperm(len(last), generator=g)[
        :n_last].tolist()]
            + [inner[i] for i in torch.randperm(len(inner), generator=g)[
                :B - n_last].tolist()])
    pick = [pick[i] for i in torch.randperm(B, generator=g).tolist()]
    ep = torch.tensor([e for e, _ in pick])
    t = torch.tensor([s for _, s in pick])
    # the last `invalid` rows: the first `shared` of them repeat the
    # (ep, t) of rows 0, 1, ... and are marked invalid below (as a mesh
    # rank's empty-shard rows are), the others sample an empty slot
    empty = torch.nonzero(~stored)[:, 0]
    for i in range(invalid):
        r = B - 1 - i
        ep[r], t[r] = ((ep[i], t[i]) if i < shared
                       else (empty[i % empty.numel()], 0))
    # rows invalid + 1 ... repeat the (ep, t) of row `invalid`
    for i in range(dup):
        ep[invalid + 1 + i], t[invalid + 1 + i] = ep[invalid], t[invalid]
    rs = dataclasses.replace(rs, **{
        f.name: getattr(rs, f.name).to(device)
        for f in dataclasses.fields(rs)})
    mb = base.gather_minibatch(rs, ep.to(ep_dtype).to(device),
                               t.to(torch.int32).to(device))
    if shared:
        valid = mb.valid.clone()
        valid[B - shared:] = False
        mb = mb._replace(valid=valid)
    rho = torch.exp(torch.randn(B, generator=g) * 1.2)
    rows = {"rho": rho,
            "dkl": torch.rand(B, generator=g),
            "delta": torch.randn(B, generator=g) * 2,
            "value": torch.randn(B, generator=g) + 3,
            "advantage": torch.randn(B, generator=g),
            "v_next": torch.randn(B, generator=g) * 0.5}
    rows = {k: v.to(device) for k, v in rows.items()}
    rows["is_far"] = rb.is_far_policy(rows["rho"], rs.cmax_ret, rs.cinv_ret)
    grads = {"W": torch.randn((5, 7), generator=g),
             "b": torch.randn(9000, generator=g) * 1e-2,
             "out": [torch.randn(3, generator=g), torch.zeros(1)]}
    grads = {k: ([x.to(device) for x in v] if isinstance(v, list)
                 else v.to(device)) for k, v in grads.items()}
    opt_step = torch.full((), step, dtype=torch.int32, device=device)
    return rs, mb, rows, grads, opt_step


TAIL_FIELDS = ("rho_tm", "kl_tm", "delta_tm", "value_tm", "advantage_tm",
               "far_count", "v_trunc", "cmax_ret", "cinv_ret", "beta",
               "alpha", "max_abs_error")


def tail_fields(rs) -> dict:
    return {f: getattr(rs, f).clone() for f in TAIL_FIELDS}


def mesh_tails(device, mesh, seed):
    """One tail under `mesh` through step_tail_, then through the chain,
    from one case with invalid rows -> ((fields, metrics) of each, the
    collectives each issued by kind, step_tail_'s launches)."""
    c = cfg()
    rs, mb, r, grads, step = case(device, seed=seed, invalid=3, shared=1)
    ref = clone_replay(rs)
    cuda_lib.reset_launches()
    mesh.counts.clear()
    _, got = base.step_tail_(rs, mb, c, step, grads, **r, mesh=mesh)
    counts = {"kernel": dict(mesh.counts)}
    launches = dict(stk.launches)
    mesh.counts.clear()
    _, want = base.step_tail_plain_(ref, mb, c, step, grads, **r,
                                    mesh=mesh)
    counts["chain"] = dict(mesh.counts)
    return ((tail_fields(rs), {k: v.clone() for k, v in got.items()}),
            (tail_fields(ref), {k: v.clone() for k, v in want.items()}),
            counts, launches)


def mesh_rank(rank, store, out_dir, device="cuda:0"):
    """One of two gloo ranks on `device` (a spawned process): mesh_tails
    from a case of its own, saved to out_dir/rank<rank>.pt."""
    import torch.distributed as dist

    from smarties_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("gloo", init_method=store, world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        got, want, counts, launches = mesh_tails(dev, make_mesh(dev),
                                                 seed=30 + rank)
        cpu = lambda d: {k: v.cpu() for k, v in d.items()}
        torch.save({"kernel": (cpu(got[0]), cpu(got[1])),
                    "chain": (cpu(want[0]), cpu(want[1])),
                    "counts": counts, "launches": launches},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def two_ranks(tmp_path, device):
    """mesh_rank on two spawned gloo ranks on `device` -> their results,
    checked for what holds on every device: each rank's tail issued the
    chain's three collectives, and the ReF-ER scalars and the metrics,
    which are global, agree across the ranks (but grad_norm and
    grad_max: each rank's gradients are its own here, where a learner
    sums them over the ranks first)."""
    import torch.multiprocessing as mp
    mp.spawn(mesh_rank, args=(f"file://{tmp_path}/store", str(tmp_path),
                              device), nprocs=2, join=True)
    outs = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"),
                       weights_only=True) for r in range(2)]
    for o in outs:
        assert o["counts"] == {"kernel": {"psum": 2, "pmax": 1},
                               "chain": {"psum": 2, "pmax": 1}}
    (f0, m0), (f1, m1) = outs[0]["kernel"], outs[1]["kernel"]
    for f in ("cmax_ret", "cinv_ret", "beta", "alpha", "max_abs_error"):
        assert torch.equal(f0[f], f1[f]), f
    for k in stk.METRICS:
        if k not in ("grad_norm", "grad_max"):
            assert torch.equal(m0[k], m1[k]), k
    return outs

"""The tail of a learner's grad step as two hand-written CUDA launches.

`tail_(rs, mb, cfg, opt_step, grads, rho, dkl, delta, value, advantage,
v_next, is_far, net2v, mesh)` does on the card what algos/base.py::
step_tail_plain_ does with some 170-190 small PyTorch kernels: the
write-back of the sampled rows into the replay (rho, KL, delta, value,
advantage, the far-policy count, the v_trunc refresh), update_cmax, the
ReF-ER beta / alpha fixed point, the max_abs_error EMA, the step metrics
and grad_stats. One launch of csrc/step_tail.cu reduces the gradient
leaves to per-block partials (`grad_stats`), the next does the rest
(`step_tail`). It returns (rs, metrics) as the chain does, with the
metrics as 0-d views of one device buffer. The host reads nothing, so a
step stays capturable (runtime/graphs.py).

Under a learner mesh (parallel/mesh.py) the collectives sit between the
rows and the scalars. `step_tail` then stops after the rows with this
rank's stored and far counts, largest |delta| and five means in small
buffers. The wrapper all-reduces them with the chain's three collectives
(psum of the counts, pmax of the error, psum of the means), and a
one-thread launch (`finish`) does the scalars and the metrics from the
totals.

The replay's values and scalars are bit-equal to the chain: the kernel
keeps its operations, their order and their rounding, and gets the
chain's constants as float32 arguments rounded as PyTorch rounds a Python
scalar for a float32 op (`scalar_args`). The metrics are sums in a fixed
order, within float rounding of the chain's; frac_far_data, beta and
grad_max are exact. A row with mb.valid False writes no field, as in the
chain (algos/base.py::write_back); of rows that repeat an (ep, t) one
row's values are stored, which the chain leaves unspecified too.

algos/base.py::step_tail_ dispatches: CUDA tensors come here, with or
without a mesh; what the kernel does not take raises (a replay field
that is not float32 or not contiguous, tensors on two devices, rows of
another length or type). There is no fallback. `launches` counts the
launches; runtime/graphs.py counts them over replays.

Build: at first use, never at import, through ops/cuda_lib.py, with
--fmad=false so that no multiply and add contract into an FMA.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from smarties_tpu_torch.ops.cuda_lib import Library
from smarties_tpu_torch.ops.leaf_table import LeafTables
from smarties_tpu_torch.parallel.mesh import pmax_, psum_

launches = {"step_tail": 0, "grad_stats": 0, "finish": 0}
# the kernel's sizes (csrc/step_tail.cu): leaves a grad_stats launch
# takes, gradient elements a grad_stats block, replay slots a tail block
MAX_LEAVES, STAT_ELEMS, SLOT_ELEMS = 64, 16 * 256, 4 * 256
METRICS = ("avg_dkl", "avg_rho", "frac_far_batch", "frac_far_data", "beta",
           "rmse", "avg_v", "grad_norm", "grad_max")
_tables = LeafTables()


def _check_sizes(lib):
    sizes = (lib.smt_step_tail_max_leaves(), lib.smt_step_tail_stat_elems(),
             lib.smt_step_tail_slot_elems(), lib.smt_step_tail_metrics())
    if sizes != (MAX_LEAVES, STAT_ELEMS, SLOT_ELEMS, len(METRICS)):
        raise RuntimeError(f"step_tail_kernel: the library's sizes {sizes} "
                           f"differ from the wrapper's")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = Library(
    "smt_step_tail", ("step_tail.cu",),
    ("--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"),
    {"smt_grad_stats": [_P, _P, _I, _P, _P, _P, _P],
     "smt_step_tail": [_P, _P, _I, _I, _P, _I] + [_F] * 6 + [_P, _I, _P],
     "smt_step_tail_finish": [_P, _I] + [_F] * 6 + [_P, _I, _I, _P],
     "smt_step_tail_max_leaves": [], "smt_step_tail_stat_elems": [],
     "smt_step_tail_slot_elems": [], "smt_step_tail_metrics": []},
    counters=(launches,), check=_check_sizes)


def scalar_args(cfg) -> tuple:
    """The tail's float32 constants (clipImpWeight, epsAnneal,
    0.1 * batchSize, maxTotObsNum, penalTol, 1e-3), each rounded from the
    Python double that the chain hands a float32 op."""
    return tuple(np.float32(x) for x in (
        cfg.clipImpWeight, cfg.epsAnneal, 0.1 * cfg.batchSize,
        float(cfg.maxTotObsNum), cfg.penalTol, 1e-3))


def grad_parts(sizes) -> tuple:
    """(partials, launches) of grad_stats over leaves of these sizes: one
    launch per MAX_LEAVES leaves, each of at least one block."""
    chunks = [sizes[i:i + MAX_LEAVES]
              for i in range(0, max(len(sizes), 1), MAX_LEAVES)]
    return (sum(max(1, sum(-(-n // STAT_ELEMS) for n in c)) for c in chunks),
            len(chunks))


def _fail(msg):
    raise ValueError(f"step_tail_kernel: {msg}")


def _check_fields(rs, dev):
    """The replay's fields and scalars the tail reads and writes."""
    shape = tuple(rs.rho_tm.shape)
    if len(shape) != 2:
        _fail(f"rho_tm of shape {shape}, expected [L1, E]")
    E = shape[1]
    for name in ("rho_tm", "kl_tm", "delta_tm", "value_tm", "advantage_tm",
                 "far_count", "v_trunc", "slot_len", "slot_id"):
        x = getattr(rs, name)
        want = (shape if name.endswith("_tm") else (E,),
                torch.int32 if name.startswith("slot") else torch.float32)
        if (tuple(x.shape), x.dtype) != want or x.device != dev \
                or not x.is_contiguous():
            _fail(f"{name} is a {tuple(x.shape)} {x.dtype} on {x.device} "
                  f"(contiguous: {x.is_contiguous()}); the kernel takes a "
                  f"contiguous {want[1]} {want[0]} on {dev}")
    for name in ("cmax_ret", "cinv_ret", "beta", "alpha", "max_abs_error"):
        _check_scalar(name, getattr(rs, name), torch.float32, dev)
    return E


def _check_scalar(name, x, dtype, dev):
    if x.dtype != dtype or x.device != dev or x.numel() != 1:
        _fail(f"{name} must be a one-element {dtype} on {dev}, got "
              f"{x.numel()} {x.dtype} on {x.device}")


def _rows(rows, dev):
    """(pointers, element strides, length) of the row inputs, each 1-D,
    of one length and on `dev`."""
    n = rows[0][1].numel()
    ptrs, strides = [], []
    for name, x, types in rows:
        if x.dim() != 1 or x.numel() != n or x.device != dev \
                or x.dtype not in types:
            _fail(f"{name} is a {tuple(x.shape)} {x.dtype} on {x.device}; "
                  f"the kernel takes a [{n}] "
                  f"{' or '.join(map(str, types))} on {dev}")
        ptrs.append(x.data_ptr())
        strides.append(x.stride(0))
    if n == 0:
        _fail("no rows")
    return ptrs, strides, n


def _table(leaves):
    """(pointer array, size array, leaves, partials, launches) of a
    gradient set, made once per set of pointers and sizes."""
    return _tables.get([g.data_ptr() for g in leaves],
                       [g.numel() for g in leaves], grad_parts)


def tail_(rs, mb, cfg, opt_step, grads, rho, dkl, delta, value, advantage,
          v_next, is_far, net2v=False, mesh=None):
    """algos/base.py::step_tail_plain_ on CUDA tensors, in place -> (rs,
    metrics). `grads`: the gradient tree (under a mesh already summed
    over the ranks); `net2v`: v_next is the net's raw output, which
    scale_net2v turns into a value here; `mesh`: the learner mesh whose
    collectives the tail takes part in, or None."""
    from smarties_tpu_torch.models.net import tree_leaves
    dev = rho.device
    E = _check_fields(rs, dev)
    _check_scalar("step", opt_step, torch.int32, dev)
    f32, flag, idx = (torch.float32,), (torch.bool,), (torch.int32,
                                                       torch.int64)
    row_ptrs, row_strides, n = _rows(
        [("rho", rho, f32), ("dkl", dkl, f32), ("delta", delta, f32),
         ("value", value, f32), ("advantage", advantage, f32),
         ("v_next", v_next, f32), ("rho_old", mb.rho_old, f32),
         ("valid", mb.valid, flag), ("truncated_next", mb.truncated_next,
                                     flag),
         ("is_far", is_far, flag), ("ep", mb.ep, idx), ("t", mb.t, idx)],
        dev)
    leaves = tree_leaves(grads)
    for g in leaves:
        if g.dtype != torch.float32 or g.device != dev \
                or not g.is_contiguous():
            _fail(f"a gradient leaf of {tuple(g.shape)} {g.dtype} on "
                  f"{g.device} (contiguous: {g.is_contiguous()}); the "
                  f"kernel takes contiguous float32 leaves on {dev}")
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on a CUDA card")
    g_ptrs, g_sizes, n_leaves, n_grad, n_stat = _table(leaves)
    n_tail = max(1, -(-E // SLOT_ELEMS))
    # one scratch of 8-byte words: part_n, part_far [n_tail] each,
    # grad_sq [n_grad], grad_max [n_grad] floats, the arrival counter
    scratch = torch.empty((2 * n_tail + n_grad + (n_grad + 1) // 2 + 1,),
                          dtype=torch.float64, device=dev)
    base = scratch.data_ptr()
    part_sq = base + 16 * n_tail
    part_max = part_sq + 8 * n_grad
    arrivals = base + 8 * (scratch.numel() - 1)
    metrics = torch.empty((len(METRICS),), dtype=torch.float32, device=dev)
    # under a mesh: the collectives' buffers (counts; largest error and
    # means) and the gradient totals
    coll = [None] * 4
    if mesh is not None:
        counts = torch.empty((2,), dtype=torch.int64, device=dev)
        red = torch.empty((6,), dtype=torch.float32, device=dev)
        totals = torch.empty((2,), dtype=torch.float64, device=dev)
        coll = [counts.data_ptr(), red.data_ptr(), red.data_ptr() + 4,
                totals.data_ptr()]
    replay = [rs.rho_tm, rs.kl_tm, rs.delta_tm, rs.value_tm, rs.advantage_tm,
              rs.far_count, rs.v_trunc, rs.slot_len, rs.slot_id, rs.cmax_ret,
              rs.cinv_ret, rs.beta, rs.alpha, rs.max_abs_error, opt_step]
    replay_ptrs = (ctypes.c_void_p * 15)(*(x.data_ptr() for x in replay))
    scratch_ptrs = (ctypes.c_void_p * 10)(
        base, base + 8 * n_tail, part_sq, part_max, arrivals,
        metrics.data_ptr(), *coll)
    flags = (int(mb.ep.dtype == torch.int64)
             + 2 * int(mb.t.dtype == torch.int64) + 4 * int(bool(net2v)))
    LIB.launch("step_tail_kernel", dev, "smt_grad_stats", g_ptrs, g_sizes,
               n_leaves, part_sq, part_max, arrivals)
    launches["grad_stats"] += n_stat
    LIB.launch("step_tail_kernel", dev, "smt_step_tail",
               (ctypes.c_void_p * 12)(*row_ptrs),
               (ctypes.c_longlong * 12)(*row_strides), flags, n, replay_ptrs,
               E, *scalar_args(cfg), scratch_ptrs, n_grad)
    launches["step_tail"] += 1
    if mesh is not None:
        # the chain's collectives, in its order (post_step_processing,
        # then default_metrics' pmean)
        psum_(mesh, counts)
        pmax_(mesh, red[:1])
        psum_(mesh, red[1:])
        LIB.launch("step_tail_kernel", dev, "smt_step_tail_finish",
                   replay_ptrs, E, *scalar_args(cfg), scratch_ptrs, n_grad,
                   mesh.size)
        launches["finish"] += 1
    # autograd's record of in-place writes, as the chain's keeps it
    for x in replay[:7] + replay[9:14]:
        torch.autograd.graph.increment_version(x)
    return rs, dict(zip(METRICS, metrics.unbind()))

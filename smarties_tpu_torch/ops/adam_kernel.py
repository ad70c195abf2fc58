"""The Adam step of models/optim.py as one hand-written CUDA launch.

`update_(ws, gs, m1s, m2s, state, cfg, grad_factor, eps)` moves every
parameter leaf and both moments of one adam_update_ call with one launch
of csrc/adam.cu (as few as fit where a call has more leaves than one
launch's table holds), and `advance_(state, cfg, eps)` moves beta_t_1,
beta_t_2 and step with one single-thread launch. Both read and write the
0-d device scalars on the card: the host reads nothing, so a step stays
capturable (runtime/graphs.py). The result is bit-equal to the loop of
models/optim.py (`adam_update_plain_`, `adam_advance_plain_`): the kernel
keeps its operations, their order and their rounding, and gets the
loop's constants as float32 arguments rounded as PyTorch rounds a Python
scalar for a float32 op (`scalar_args`).

models/optim.py dispatches on the leaves' device: CPU leaves take the
loop, CUDA leaves come here, and what the kernel does not take raises
(a leaf that is not float32 or not contiguous, leaves on two devices, a
gradient or moment of another shape than its parameter). There is no
fallback. `launches` counts the launches (a plain dict of ints, touched
nowhere but at a launch; runtime/graphs.py counts them over replays).

Build: at first use, never at import, through ops/cuda_lib.py, with
--fmad=false so that no multiply and add contract into an FMA.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from smarties_tpu_torch.ops.cuda_lib import Library
from smarties_tpu_torch.ops.leaf_table import LeafTables

launches = {"adam_update": 0, "adam_advance": 0}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = Library(
    "smt_adam", ("adam.cu",),
    ("--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"),
    {"smt_adam_update": [_P, _P, _I, _P, _P, _P] + [_F] * 9 + [_P],
     "smt_adam_advance": [_P, _P, _P, _F, _F, _F, _P],
     "smt_adam_max_leaves": []},
    counters=(launches,))
_tables = LeafTables()


def scalar_args(cfg, grad_factor, eps) -> tuple:
    """The update's float32 arguments (gf, b1, 1 - b1, b2, 1 - b2, eps,
    lambda, eta, time_inv), each rounded from the Python double the loop
    hands a float32 op. Without annealing time_inv is 0: the kernel's
    1 / (1 + step * 0) * eta is then eta exactly."""
    b1, b2 = cfg.beta1, cfg.beta2
    return tuple(np.float32(x) for x in (
        grad_factor, b1, 1 - b1, b2, 1 - b2, eps, cfg.lambda_, cfg.eta,
        cfg.eps_anneal if cfg.anneal_lr else 0.0))


def _check_scalars(state, dev):
    for name, x, dtype in (("beta_t_1", state.beta_t_1, torch.float32),
                           ("beta_t_2", state.beta_t_2, torch.float32),
                           ("step", state.step, torch.int32)):
        if x.dtype != dtype or x.device != dev or x.numel() != 1:
            raise ValueError(f"adam_kernel: {name} must be a one-element "
                             f"{dtype} on {dev}, got {x.dtype} on {x.device}")


def _check(ws, gs, m1s, m2s, state):
    dev = ws[0].device
    if not len(ws) == len(gs) == len(m1s) == len(m2s):
        raise ValueError(f"adam_kernel: {len(ws)} params, {len(gs)} grads, "
                         f"{len(m1s)} and {len(m2s)} moments")
    for w, g, m1, m2 in zip(ws, gs, m1s, m2s):
        for name, x in (("param", w), ("grad", g), ("m1", m1), ("m2", m2)):
            if (x.dtype != torch.float32 or x.device != dev
                    or not x.is_contiguous() or x.shape != w.shape):
                raise ValueError(
                    f"adam_kernel: a {name} of {tuple(x.shape)} {x.dtype} "
                    f"on {x.device} (contiguous: {x.is_contiguous()}) for "
                    f"a float32 {tuple(w.shape)} param on {dev}: the kernel "
                    f"takes contiguous float32 leaves of one shape on one "
                    f"device")
    _check_scalars(state, dev)


def _table(ws, gs, m1s, m2s):
    """(pointer array, size array, leaves, launches) of a leaf set, made
    once per set of pointers and sizes."""
    ptrs = [x.data_ptr() for leaf in zip(ws, gs, m1s, m2s) for x in leaf]
    return _tables.get(ptrs, [w.numel() for w in ws], _launches)


def _launches(sizes) -> tuple:
    """(launches,) of an update over leaves of these sizes: one per
    table of leaves with an element."""
    per = LIB.load().smt_adam_max_leaves()
    return (sum(any(sizes[i:i + per]) for i in range(0, len(sizes), per)),)


def update_(ws, gs, m1s, m2s, state, cfg, grad_factor, eps):
    """adam_update_plain_ on CUDA leaves (lists of the params', grads' and
    moments' leaves), in place, with state's scalars read on the card."""
    _check(ws, gs, m1s, m2s, state)
    ptrs, sizes, n, n_launches = _table(ws, gs, m1s, m2s)
    LIB.launch("adam_kernel", ws[0].device, "smt_adam_update", ptrs, sizes,
               n, state.step.data_ptr(), state.beta_t_1.data_ptr(),
               state.beta_t_2.data_ptr(), *scalar_args(cfg, grad_factor, eps))
    launches["adam_update"] += n_launches
    # autograd's record of in-place writes, as the loop's add_ / copy_ keep it
    for x in (*ws, *m1s, *m2s):
        torch.autograd.graph.increment_version(x)


def advance_(state, cfg, eps):
    """adam_advance_plain_ on CUDA scalars, in place: one launch."""
    dev = state.step.device
    _check_scalars(state, dev)
    LIB.launch("adam_kernel", dev, "smt_adam_advance",
               state.beta_t_1.data_ptr(), state.beta_t_2.data_ptr(),
               state.step.data_ptr(), np.float32(cfg.beta1),
               np.float32(cfg.beta2), np.float32(eps))
    launches["adam_advance"] += 1

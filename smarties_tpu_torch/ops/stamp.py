"""Phase stamps: a timestamp written into a row of a device buffer, in
stream order, from inside a captured program.

`stamp_(buf, row, col)` sets buf[row[0], col] to the time at which the
stream reaches it: on a CUDA device one single-thread launch of
csrc/stamp.cu, which reads the card's global timer (%globaltimer, ns);
on the CPU, where every op has finished when the next one starts,
time.perf_counter_ns(). `row` is a 0-based device counter ([1] int64),
read by the kernel, so a replayed graph stamps a new row each step; None
stamps row 0. `on_grad(x, mark)` marks where a backward pass reaches x.
utils/profiler.py maps the card's timer onto the host's clock. The
library is built at first use, never at import, through ops/cuda_lib.py.
"""
from __future__ import annotations

import ctypes
import time

import torch

from smarties_tpu_torch.ops.cuda_lib import Library

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = Library("smt_stamp", ("stamp.cu",), ("-shared", "-Xcompiler", "-fPIC"),
              {"smt_stamp": [_P, _P, _I, _I, _P],
               "smt_timer_ticks": [_P, _I, _P]})


def stamp_(buf: torch.Tensor, row, col: int) -> torch.Tensor:
    """buf[row[0], col] = now (row None: row 0), in stream order; buf is a
    contiguous int64 [rows, n_cols] tensor and row an int64 [1] tensor on
    its device. Returns buf."""
    if buf.dtype != torch.int64 or buf.dim() != 2 or not buf.is_contiguous():
        raise ValueError(f"stamp_: expected a contiguous int64 [rows, "
                         f"n_cols] buffer, got {tuple(buf.shape)} "
                         f"{buf.dtype}")
    if buf.device.type == "cpu":
        if row is None:
            buf[0, col] = time.perf_counter_ns()
        else:
            buf[:, col].index_fill_(0, row, time.perf_counter_ns())
        return buf
    if row is not None and (row.device != buf.device
                            or row.dtype != torch.int64):
        raise ValueError(f"stamp_: row must be int64 on {buf.device}")
    LIB.launch("stamp_", buf.device, "smt_stamp", buf.data_ptr(),
               None if row is None else row.data_ptr(), buf.shape[1], col)
    return buf


class _OnGrad(torch.autograd.Function):
    """The identity; its backward calls `mark()` before it passes the
    gradient on."""

    @staticmethod
    def forward(ctx, x, mark):
        ctx.mark = mark
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.mark()
        return g, None


def on_grad(x: torch.Tensor, mark) -> torch.Tensor:
    """x, through an identity whose backward calls mark() (a stamp) when
    the backward pass reaches it, before the ops that produced x take
    their gradients: the boundary of the two in stream order."""
    return _OnGrad.apply(x, mark)


def timer_ticks_ns(device, n: int = 64) -> list:
    """The card's timer resolution: the differences (ns) of n successive
    distinct readings of %globaltimer. A synchronisation."""
    device = torch.device(device)
    out = torch.zeros((n,), dtype=torch.int64, device=device)
    LIB.launch("timer_ticks_ns", device, "smt_timer_ticks", out.data_ptr(),
               n)
    return out.tolist()

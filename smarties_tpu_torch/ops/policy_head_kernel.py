"""V-RACER's continuous policy head as one hand-written CUDA launch.

`continuous_head(out, action, mu, qret, valid, bounded, cmax, cinv,
beta)` does on the card what algos/vracer.py::VRacer.output_grad_plain
does with some 167 small PyTorch kernels for V-RACER's continuous
actions (the zero advantage): from the net's output at the sampled rows
[B, 1 + 2nA] (V, the means, the raw stdevs) to the analytic output
gradient g [B, 1 + 2nA] that the pullback receives, and the rows the
step's tail writes back (rho, the KL, the TD error, V, the advantage,
which is 0, and the far-policy flags). One launch of csrc/policy_head.cu,
one thread a row. It reads the replay's cmax_ret, cinv_ret and beta on
the device, so the host reads nothing and a step stays capturable
(runtime/graphs.py).

The outputs are bit-equal to the chain on the card: the kernel keeps its
operations, their order and their rounding, and its sums over the action
dims take the order of PyTorch's reduce kernel. The chain's constants
reach it as float32 arguments rounded as PyTorch rounds a Python scalar
for a float32 op (`scalar_args`, the rule of step_tail_kernel.scalar_args).

algos/vracer.py::VRacer.output_grad dispatches: CUDA tensors of V-RACER's
continuous head come here; the CPU, RACER's Gaussian advantage and the
discrete head keep the chain. What the kernel does not take raises (an
input that is not float32, or bool for the masks, not contiguous, on two
devices or of another shape; more than MAX_DIMS action dims). There is
no fallback. `launches` counts the launches; runtime/graphs.py counts
them over replays.

Build: at first use, never at import, through ops/cuda_lib.py, with
--fmad=false so that no multiply and add contract into an FMA.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from smarties_tpu_torch.ops import continuous_policy as cp
from smarties_tpu_torch.ops.cuda_lib import Library

launches = {"continuous": 0}
# action dims a row may have (csrc/policy_head.cu's kMaxDims)
MAX_DIMS = 32


def _check_sizes(lib):
    if lib.smt_policy_head_max_dims() != MAX_DIMS:
        raise RuntimeError(f"policy_head_kernel: the library's "
                           f"{lib.smt_policy_head_max_dims()} action dims "
                           f"differ from the wrapper's {MAX_DIMS}")


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = Library(
    "smt_policy_head", ("policy_head.cu",),
    ("--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"),
    {"smt_policy_head": [_P, _P, _I, _I] + [_F] * 4 + [_P],
     "smt_policy_head_max_dims": []},
    counters=(launches,), check=_check_sizes)


def scalar_args() -> tuple:
    """The head's float32 constants (MEAN_MAX, log sqrt(2 pi), float32's
    smallest normal, the log-weight clip), each rounded from the Python
    double that the chain hands a float32 op."""
    return tuple(np.float32(x) for x in (
        cp.MEAN_MAX, cp._LOG_SQRT_2PI, cp._F32_TINY, cp._LOGW_CLIP))


def _fail(msg):
    raise ValueError(f"policy_head_kernel: {msg}")


def _check(name, x, shape, dtype, dev):
    if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev \
            or not x.is_contiguous():
        _fail(f"{name} is a {tuple(x.shape)} {x.dtype} on {x.device} "
              f"(contiguous: {x.is_contiguous()}); the kernel takes a "
              f"contiguous {dtype} {shape} on {dev}")


def check_inputs(out, action, mu, qret, valid, bounded, cmax, cinv, beta):
    """Raise where the kernel does not take these inputs, on any device
    -> (rows, action dims)."""
    if not cp.OPPOSITE_KL:
        _fail("the kernel computes DKL(pi || mu) (OPPOSITE_KL)")
    if out.dim() != 2 or out.shape[1] % 2 != 1 or out.shape[0] == 0:
        _fail(f"out is a {tuple(out.shape)}; the kernel takes the net's "
              f"[B, 1 + 2nA] outputs at B > 0 rows")
    B, nA = out.shape[0], out.shape[1] // 2
    if not 0 < nA <= MAX_DIMS:
        _fail(f"{nA} action dims; the kernel takes 1 to {MAX_DIMS}")
    dev, f32 = out.device, torch.float32
    _check("out", out, (B, 1 + 2 * nA), f32, dev)
    _check("action", action, (B, nA), f32, dev)
    _check("mu", mu, (B, 2 * nA), f32, dev)
    _check("qret", qret, (B,), f32, dev)
    _check("valid", valid, (B,), torch.bool, dev)
    _check("bounded", bounded, (nA,), torch.bool, dev)
    for name, x in (("cmax", cmax), ("cinv", cinv), ("beta", beta)):
        _check(name, x, (), f32, dev)
    return B, nA


def continuous_head(out, action, mu, qret, valid, bounded, cmax, cinv,
                    beta):
    """VRacer.output_grad_plain's head on CUDA tensors -> (g, rho, dkl,
    delta_q, v_val, a_val, is_far). out: the net's outputs at the B
    sampled rows; bounded: the MDP's per-dim mask on the device; cmax,
    cinv, beta: the replay's 0-d scalars."""
    B, nA = check_inputs(out, action, mu, qret, valid, bounded, cmax, cinv,
                         beta)
    dev = out.device
    if dev.type != "cuda":
        _fail(f"tensors on {dev}: the kernel runs on a CUDA card")
    g = torch.empty((B, 1 + 2 * nA), dtype=torch.float32, device=dev)
    rows = torch.empty((5, B), dtype=torch.float32, device=dev)
    is_far = torch.empty((B,), dtype=torch.bool, device=dev)
    ins = (out, action, mu, qret, valid, bounded, cmax, cinv, beta)
    outs = (g, *rows, is_far)
    LIB.launch("policy_head_kernel", dev, "smt_policy_head",
               (ctypes.c_void_p * 9)(*(x.data_ptr() for x in ins)),
               (ctypes.c_void_p * 7)(*(x.data_ptr() for x in outs)),
               B, nA, *scalar_args())
    launches["continuous"] += 1
    rho, dkl, delta_q, v_val, a_val = rows.unbind()
    return g, rho, dkl, delta_q, v_val, a_val, is_far

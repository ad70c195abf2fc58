"""K1: the Retrace suffix-scan kernel, hand-written in CUDA C++ for Hopper.

Replaces smarties_tpu/ops/pallas_retrace.py::affine_suffix_scan (the
one Pallas kernel of the JAX package) and its wrapper
batched_retrace_pallas. The CUDA source is csrc/retrace.cu; its header
note says what bounds the kernel on the H100 and how the design meets it.

Three entry points share the device code:

- `affine_suffix_scan(a, b) -> q`: the TPU kernel's own contract,
  q[e, t] = a[e, t] + b[e, t] * q[e, t+1] over [E, L1] float32.
- `batched_retrace(r_scaled, value, advantage, rho, length, terminal,
  gamma, lam, mode) -> qret`: coefficients (`retrace_coeffs`), the scan
  and the t > length mask in one pass.
- `retrace_sweep_(qret_tm, rewards_tm, value_tm, advantage_tm, rho_tm,
  v_trunc, slot_len, slot_term, select, rew_mean, rew_scale, gamma, lam,
  mode, zero_unselected)`: the replay's sweep, in place on its stored
  time-major fields. Reward scaling, the v_trunc substitution, the
  recursion and the per-slot select are one kernel launch. Both sweeps of
  replay/buffer.py, and so every site of the main path, call this one.

Dispatch is by the tensors' device, with no fallback: CPU tensors go to
the plain torch versions in ops/returns.py; CUDA tensors launch the
kernel, and anything the kernel does not take raises. Each entry point
counts its kernel launches in `launches` (a plain dict of ints, touched
nowhere but at a launch; `launch_modes` counts the same launches by
Retrace or GAE), so a run can show that it went through the kernel.
The kernel has no gradient and needs none: returns are
regression targets, never differentiated.

Layouts: the first two entry points take and return the JAX package's
[E, L1] orientation. An [E, L1] argument may be row-major (slot-major)
or the transposed view of a time-major [L1, E] tensor — the layout the
port's replay stores, in which a warp's loads coalesce and which the
kernel prefetches through its async-copy pipeline; slot-major input
takes a plain loop. All arrays of one call must share the layout; the
output is allocated in it. No copy is made. `retrace_sweep_` takes the
contiguous time-major [L1, E] tensors themselves.

Build: at first use (never at import), through ops/cuda_lib.py. The
pipeline's producer warps, tile depth and stages are compile-time
constants of csrc/retrace.cu (SMT_PRODUCERS, SMT_STEPS, SMT_STAGES),
changed by editing the source.
"""
from __future__ import annotations

import ctypes

import torch

from smarties_tpu_torch.ops.cuda_lib import Library
from smarties_tpu_torch.ops.returns import (affine_suffix_scan_plain,
                                            batched_retrace_plain,
                                            retrace_sweep_plain_)

# kernel launches per entry point (zeroed by cuda_lib.reset_launches)
launches = {"affine_suffix_scan": 0, "batched_retrace": 0,
            "retrace_sweep": 0}
# the same launches of the two return estimators by their mode
launch_modes = {"retrace": 0, "GAE": 0}
_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
LIB = Library(
    "smt_retrace", ("retrace.cu",),
    ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"),
    {"smt_affine_suffix_scan": [_P, _P, _P, _I, _I, _LL, _LL, _I, _P],
     "smt_batched_retrace": [_P] * 7 + [_I, _I, _LL, _LL, _F, _F, _F, _F,
                                        _I, _I, _P],
     "smt_retrace_sweep": [_P] * 11 + [_I, _I, _F, _F, _F, _F, _I, _I, _P],
     "smt_pipeline_smem_bytes": [_I]},
    counters=(launches, launch_modes))
library = LIB.load


def _strides(arrays, names):
    """Common (stride_e, stride_t) of float32 [E, L1] CUDA arrays that are
    row-major or transposed time-major; raises on anything else."""
    x0 = arrays[0]
    if x0.dim() != 2:
        raise ValueError(f"{names[0]}: expected [E, L1], got "
                         f"{tuple(x0.shape)}")
    E, L1 = x0.shape

    def layout(x):
        if x.is_contiguous():
            return (L1, 1)             # slot-major [E, L1]
        if x.t().is_contiguous():
            return (1, E)              # view of time-major [L1, E]
        return None

    want = layout(x0)
    for x, n in zip(arrays, names):
        if x.device != x0.device:
            raise ValueError(f"{n}: on {x.device}, expected {x0.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{n}: dtype {x.dtype}, expected torch.float32")
        if tuple(x.shape) != (E, L1):
            raise ValueError(f"{n}: shape {tuple(x.shape)}, expected "
                             f"{(E, L1)}")
        lay = layout(x)
        if lay is None or lay != want:
            raise ValueError(
                f"{n}: strides {x.stride()} are neither row-major [E, L1] "
                f"nor a transposed time-major [L1, E], or differ from "
                f"{names[0]}'s")
    return E, L1, want


def affine_suffix_scan(a, b):
    """q[e, t] = a[e, t] + b[e, t] * q[e, t+1], q beyond L1-1 = 0.

    a, b: [E, L1] float32 -> q [E, L1] in their layout. CPU: the plain
    loop; CUDA: one kernel launch on the current stream, not synchronised."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return affine_suffix_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"affine_suffix_scan: unsupported device {a.device}")
    E, L1, (se, st) = _strides((a, b), ("a", "b"))
    q = torch.empty_strided((E, L1), (se, st), dtype=torch.float32,
                            device=a.device)
    if E == 0 or L1 == 0:
        return q
    # 1: time-major input takes the pipeline, row-major input the loop
    LIB.launch("affine_suffix_scan", a.device, "smt_affine_suffix_scan",
               a.data_ptr(), b.data_ptr(), q.data_ptr(), E, L1, se, st, 1)
    launches["affine_suffix_scan"] += 1
    return q


def _check_slots(x, name, dtype, E, device):
    if x.device != device or x.dtype != dtype or tuple(x.shape) != (E,) \
            or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous [{E}] {dtype} "
                         f"tensor on {device}, got {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")


def batched_retrace(r_scaled, value, advantage, rho, length, terminal,
                    gamma: float, lam: float, mode: str = "retrace"):
    """qret [E, L1] of the Retrace ("retrace") or GAE ("GAE") backward
    recursion, 0 for t > length — batched_retrace_pallas's result.

    r_scaled, value, advantage, rho: [E, L1] float32 in one layout;
    length: [E] int32 with 0 <= length <= L1-1; terminal: [E] bool.
    CPU: `batched_retrace_plain`; CUDA: one kernel launch on the current
    stream, not synchronised."""
    if mode not in ("retrace", "GAE"):
        raise ValueError(f"batched_retrace: mode {mode!r} is not affine")
    floats = (r_scaled, value, advantage, rho)
    devs = {x.device.type for x in floats + (length, terminal)}
    if devs == {"cpu"}:
        return batched_retrace_plain(r_scaled, value, advantage, rho,
                                     length, terminal, gamma, lam, mode)
    if devs != {"cuda"}:
        raise ValueError(f"batched_retrace: unsupported devices {devs}")
    E, L1, (se, st) = _strides(floats, ("r_scaled", "value", "advantage",
                                        "rho"))
    _check_slots(length, "length", torch.int32, E, r_scaled.device)
    _check_slots(terminal, "terminal", torch.bool, E, r_scaled.device)
    q = torch.empty_strided((E, L1), (se, st), dtype=torch.float32,
                            device=r_scaled.device)
    if E == 0 or L1 == 0:
        return q
    LIB.launch(
        "batched_retrace", r_scaled.device, "smt_batched_retrace",
        r_scaled.data_ptr(), value.data_ptr(), advantage.data_ptr(),
        rho.data_ptr(), length.data_ptr(), terminal.data_ptr(), q.data_ptr(),
        E, L1, se, st, gamma, lam, gamma * lam, gamma * (1 - lam),
        int(mode == "GAE"), 1)
    launches["batched_retrace"] += 1
    launch_modes[mode] += 1
    return q


def retrace_sweep_(qret_tm, rewards_tm, value_tm, advantage_tm, rho_tm,
                   v_trunc, slot_len, slot_term, select, rew_mean, rew_scale,
                   gamma: float, lam: float, mode: str = "retrace",
                   zero_unselected: bool = False):
    """The replay's Retrace ("retrace") or GAE ("GAE") sweep over its
    stored fields, written into `qret_tm` in place; returns qret_tm.

    qret_tm, rewards_tm, value_tm, advantage_tm, rho_tm: contiguous
    time-major [L1, E] float32; v_trunc [E] float32 (the value at
    t == length, taken wherever that value is read); slot_len [E] int32
    (clamped to [0, L1-1]); slot_term, select [E] bool; rew_mean,
    rew_scale: 0-d float32 tensors on the same device, read by the kernel
    (the reward enters as (r - rew_mean) * rew_scale). For a slot with
    select[e], qret gets the recursion for t <= length and 0 beyond. Any
    other slot is not read; its row stays, or is zeroed when
    `zero_unselected`. CPU: `retrace_sweep_plain_`; CUDA: one kernel
    launch on the current stream, not synchronised."""
    if mode not in ("retrace", "GAE"):
        raise ValueError(f"retrace_sweep_: mode {mode!r} is not affine")
    fields = (qret_tm, rewards_tm, value_tm, advantage_tm, rho_tm)
    slots = (v_trunc, slot_len, slot_term, select)
    scalars = (rew_mean, rew_scale)
    devs = {x.device.type for x in fields + slots + scalars}
    if devs == {"cpu"}:
        return retrace_sweep_plain_(
            qret_tm, rewards_tm, value_tm, advantage_tm, rho_tm, v_trunc,
            slot_len, slot_term, select, rew_mean, rew_scale, gamma, lam,
            mode, zero_unselected)
    if devs != {"cuda"}:
        raise ValueError(f"retrace_sweep_: unsupported devices {devs}")
    dev = qret_tm.device
    if qret_tm.dim() != 2:
        raise ValueError(f"qret_tm: expected [L1, E], got "
                         f"{tuple(qret_tm.shape)}")
    L1, E = qret_tm.shape
    for x, n in zip(fields, ("qret_tm", "rewards_tm", "value_tm",
                             "advantage_tm", "rho_tm")):
        if x.device != dev or x.dtype != torch.float32 \
                or tuple(x.shape) != (L1, E) or not x.is_contiguous():
            raise ValueError(f"{n}: expected a contiguous [{L1}, {E}] "
                             f"float32 tensor on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
    _check_slots(v_trunc, "v_trunc", torch.float32, E, dev)
    _check_slots(slot_len, "slot_len", torch.int32, E, dev)
    _check_slots(slot_term, "slot_term", torch.bool, E, dev)
    _check_slots(select, "select", torch.bool, E, dev)
    for x, n in zip(scalars, ("rew_mean", "rew_scale")):
        if x.device != dev or x.dtype != torch.float32 or x.dim() != 0:
            raise ValueError(f"{n}: expected a 0-d float32 tensor on {dev}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    if E == 0 or L1 == 0:
        return qret_tm
    LIB.launch(
        "retrace_sweep_", dev, "smt_retrace_sweep", qret_tm.data_ptr(),
        rewards_tm.data_ptr(), value_tm.data_ptr(), advantage_tm.data_ptr(),
        rho_tm.data_ptr(), v_trunc.data_ptr(), slot_len.data_ptr(),
        slot_term.data_ptr(), select.data_ptr(), rew_mean.data_ptr(),
        rew_scale.data_ptr(), E, L1, gamma, lam, gamma * lam,
        gamma * (1 - lam), int(mode == "GAE"), int(zero_unselected))
    launches["retrace_sweep"] += 1
    launch_modes[mode] += 1
    return qret_tm

"""K1: the Retrace suffix-scan kernel, hand-written in CUDA C++ for Hopper.

Replaces smarties_tpu/ops/pallas_retrace.py::affine_suffix_scan (the
one Pallas kernel of the JAX package) and its wrapper
batched_retrace_pallas. The CUDA source is csrc/retrace.cu; its header
note says what bounds the kernel on the H100 and how the design meets it.

Two entry points share one device loop:

- `affine_suffix_scan(a, b) -> q`: the TPU kernel's own contract,
  q[e, t] = a[e, t] + b[e, t] * q[e, t+1] over [E, L1] float32.
- `batched_retrace(r_scaled, value, advantage, rho, length, terminal,
  gamma, lam, mode) -> qret`: coefficients (`retrace_coeffs`), the scan
  and the t > length mask in one pass. The main path calls this one.

Dispatch is by the tensors' device, with no fallback: CPU tensors go to
the plain torch versions in ops/returns.py; CUDA tensors launch the
kernel, and anything the kernel does not take raises. Each entry point
counts its kernel launches in `launches` (a plain dict of ints, touched
nowhere but at a launch), so a run can show that it went through the
kernel. The kernel has no gradient and needs none: returns are
regression targets, never differentiated.

Layouts: both entry points take and return the JAX package's [E, L1]
orientation. An [E, L1] argument may be row-major (slot-major) or the
transposed view of a time-major [L1, E] tensor — the layout the port's
replay stores, in which a warp's loads coalesce. All arrays of one call
must share the layout; the output is allocated in it. No copy is made.

Build: at first use (never at import), nvcc compiles csrc/retrace.cu for
sm_90a into a shared library with a plain C interface under
build/smarties_tpu_torch/ at the repository root, named by a hash of the
source and flags so an edited source rebuilds; ctypes loads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

from smarties_tpu_torch.ops.returns import (affine_suffix_scan_plain,
                                            batched_retrace_plain)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = (os.path.join(_PKG_DIR, "csrc", "retrace.cu"),)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "smarties_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per entry point (reset by callers that count a run)
launches = {"affine_suffix_scan": 0, "batched_retrace": 0}
# what the last build in this process did: library path, nvcc seconds
# (None when the library was already built) and nvcc's output
build_info = {"path": None, "seconds": None, "log": ""}
_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if path is None and os.path.exists(default):
        path = default
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernel of "
                           "ops/retrace_kernel.py cannot be built")
    return path


def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libsmt_retrace_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
        build_info.update(seconds=time.perf_counter() - t0,
                          log=proc.stdout + proc.stderr)
    build_info["path"] = so
    lib = ctypes.CDLL(so)
    P, I, LL, F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
    lib.smt_affine_suffix_scan.argtypes = [P, P, P, I, I, LL, LL, P]
    lib.smt_affine_suffix_scan.restype = I
    lib.smt_batched_retrace.argtypes = [P, P, P, P, P, P, P, I, I, LL, LL,
                                        F, F, F, F, I, P]
    lib.smt_batched_retrace.restype = I
    _lib = lib
    return lib


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


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


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
    lib = library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.smt_affine_suffix_scan(a.data_ptr(), b.data_ptr(),
                                         q.data_ptr(), E, L1, se, st, stream)
    _raise_on(err, "affine_suffix_scan")
    launches["affine_suffix_scan"] += 1
    return q


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
    for x, n, dt in ((length, "length", torch.int32),
                     (terminal, "terminal", torch.bool)):
        if x.device != r_scaled.device or x.dtype != dt \
                or tuple(x.shape) != (E,) or not x.is_contiguous():
            raise ValueError(f"{n}: expected a contiguous [{E}] {dt} tensor "
                             f"on {r_scaled.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    q = torch.empty_strided((E, L1), (se, st), dtype=torch.float32,
                            device=r_scaled.device)
    if E == 0 or L1 == 0:
        return q
    lib = library()
    with torch.cuda.device(r_scaled.device):
        stream = torch.cuda.current_stream(r_scaled.device).cuda_stream
        err = lib.smt_batched_retrace(
            r_scaled.data_ptr(), value.data_ptr(), advantage.data_ptr(),
            rho.data_ptr(), length.data_ptr(), terminal.data_ptr(),
            q.data_ptr(), E, L1, se, st, gamma, lam, gamma * lam,
            gamma * (1 - lam), int(mode == "GAE"), stream)
    _raise_on(err, "batched_retrace")
    launches["batched_retrace"] += 1
    return q

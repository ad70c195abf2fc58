"""The port's hand-written CUDA libraries: build, load, launch and count.

Each kernel wrapper (ops/retrace_kernel.py, ops/adam_kernel.py,
ops/step_tail_kernel.py, ops/stamp.py) declares one `Library` at import:
its sources under csrc/, its nvcc flags, a stem and the C signatures of
its entry points (every entry point returns an int). At first use, never
at import, nvcc compiles the sources for sm_90a into a shared library
with a plain C interface under build/smarties_tpu_torch/ at the
repository root, named lib<stem>_<hash of the flags and sources>.so
(`library_path`) so that an edited source or flag rebuilds, and ctypes
loads it. `Library.launch` calls an entry point on a device's current
stream and raises on the CUDA error it returns.

Launch counters: the dicts of ints in which a wrapper counts its launches
(touched nowhere but at a launch) are registered with its Library in
COUNTERS, as a caller may register its own (`register`).
runtime/graphs.py counts over replays what a capture added to them, and
`reset_launches()` zeroes them all.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "smarties_tpu_torch")
# the flags every library starts with; the rest are each library's own
SM90A = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
# the launch counters that reset_launches() zeroes and a replay advances
COUNTERS = []
# every declared Library, in the order of declaration
LIBRARIES = []


def register(*counters):
    """Add dicts of ints to COUNTERS (each once)."""
    for counts in counters:
        if not any(counts is c for c in COUNTERS):
            COUNTERS.append(counts)


def reset_launches():
    """Zero every registered counter."""
    for counts in COUNTERS:
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if path is None and os.path.exists(default):
        path = default
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "smarties_tpu_torch/ops cannot be built")
    return path


def library_path(sources, flags, stem: str) -> str:
    """build/smarties_tpu_torch/lib<stem>_<hash of flags and sources>.so;
    reads the sources, needs no nvcc."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")


def compile_library(sources, flags, stem: str, info: dict) -> ctypes.CDLL:
    """nvcc `sources` with `flags` into `library_path`, unless that
    library is already there, and load it. Fills `info` (path, nvcc
    seconds, nvcc's output), as `Library.build_info`."""
    so = library_path(sources, flags, stem)
    info.update(path=so, seconds=None, log="")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)   # atomic: a concurrent loader sees all or none
        info.update(seconds=time.perf_counter() - t0,
                    log=proc.stdout + proc.stderr)
    return ctypes.CDLL(so)


class Library:
    """One shared library of hand-written kernels (the module docstring).

    sources: file names under csrc/; flags: nvcc's, after SM90A's;
    signatures: {entry point: argtypes}; counters: the wrapper's launch
    counters, registered here; check(lib): raises where the loaded
    library disagrees with its wrapper."""

    def __init__(self, stem: str, sources, flags, signatures, counters=(),
                 check=None):
        self.stem = stem
        self.sources = tuple(os.path.join(CSRC, s) for s in sources)
        self.flags = (*SM90A, *flags)
        self.signatures = signatures
        self.check = check
        # what the last build in this process did: library path, nvcc
        # seconds (None when the library was already built), nvcc's output
        self.build_info = {"path": None, "seconds": None, "log": ""}
        self._lib = None
        register(*counters)
        LIBRARIES.append(self)

    @property
    def path(self) -> str:
        return library_path(self.sources, self.flags, self.stem)

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def load(self) -> ctypes.CDLL:
        """Build (if needed) and load the library; cached per process."""
        if self._lib is None:
            lib = compile_library(self.sources, self.flags, self.stem,
                                  self.build_info)
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            if self.check is not None:
                self.check(lib)
            self._lib = lib
        return self._lib

    def launch(self, who: str, device, entry: str, *args):
        """entry(*args, stream) on `device` with its current stream's
        handle last; raises RuntimeError naming `who` on a nonzero
        CUDA error."""
        fn = getattr(self.load(), entry)
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{who}: CUDA launch failed with error {err}")

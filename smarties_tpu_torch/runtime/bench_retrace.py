"""K1's time on one CUDA card beside the least the card could take.

    python3 -m smarties_tpu_torch.runtime.bench_retrace          # the table
    python3 -m smarties_tpu_torch.runtime.bench_retrace --tune   # + shapes

Times the three entry points of ops/retrace_kernel.py at the main
path's [4096, 501] in the replay's time-major layout, Retrace and GAE,
with CUDA events and a cold L2 (a 64 MB write before every launch):

- `random`: slot lengths uniform in 1..500;
- `full`: every slot at length 500 (a trained cart-pole's replay);
- `ingest` (the sweep only): `random` lengths with 1024 of the 4096
  slots selected, picked at random, and the others left as they are;
  `ingest neighbours`: the same with slots 0..1023 selected;
- `sorted` (`batched_retrace`, Retrace only): the `random` lengths in
  ascending order over the slots. The card moves 32-byte sectors of 8
  neighbouring slots, whole, as long as one of the 8 is still live, so
  with lengths in random order it moves about 8/9 of the `full` case's
  input whatever the bound's count of needed elements says; sorted,
  neighbours end together and the two counts agree.

Per case: the async-copy pipeline's time, the same kernel's plain loop
on the same input (`pipelined=False`; the sweep has none), the bytes the
function must move (each input element it needs read once, each output
element written once), the bound those bytes set at the card's
published 3.35 TB/s, the share of the bound reached, and as context the
time of one torch.clone that moves as many bytes (half read, half
written). `--tune` rebuilds the kernel with other counts of producer
warps, tile depths and stage counts and times `batched_retrace` with each.

chip_smoke.py prints the same table (`measure`). Needs a CUDA card
(exits 2 without one). Imports no JAX.
"""
from __future__ import annotations

import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from smarties_tpu_torch.ops import retrace_kernel as rk
from smarties_tpu_torch.ops import returns as ret

MAIN_E, MAIN_L1 = 4096, 501
INGEST_SELECTED = 1024
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
GAMMA, LAM = 0.995, 0.95
# (SMT_PRODUCERS, SMT_STEPS, SMT_STAGES) tried by --tune beside the default
TUNE_SHAPES = ((1, 16, 4), (3, 4, 4), (3, 8, 4), (5, 4, 4), (7, 2, 4),
               (7, 4, 2), (7, 4, 6), (7, 8, 3), (11, 2, 4), (11, 4, 4),
               (15, 2, 4), (15, 4, 3))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


class ColdTimer:
    """Median ms of single launches by CUDA events, each on a cold L2.

    Before every timed launch a 64 MB write evicts the 50 MB L2 and a
    short device-side sleep follows, so the host has enqueued the launch
    and the closing event before the card reaches the opening one: the
    events then bracket device time, not the host's enqueue."""

    def __init__(self, device):
        self.scratch = torch.empty(16 * 2 ** 20, device=device)

    def __call__(self, fn, n: int) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(n):
            self.scratch.zero_()
            torch.cuda._sleep(400_000)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        return statistics.median(times)


def replay_fields(seed: int, E: int, L1: int, lengths: str, device):
    """Seeded time-major [L1, E] fields and per-slot tensors of a replay
    with `lengths` "random" (uniform in 1..L1-1), "sorted" (the same,
    ascending over the slots) or "full" (all L1-1)."""
    rng = np.random.RandomState(seed)

    def tm(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    f = {k: tm(rng.randn(L1, E)) for k in ("r", "v", "adv", "qret")}
    f["rho"] = tm(np.exp(rng.randn(L1, E)))
    f["b"] = tm(rng.rand(L1, E) * 0.9)
    lens = np.full(E, L1 - 1) if lengths == "full" else rng.randint(1, L1, E)
    if lengths == "sorted":
        lens = np.sort(lens)
    f["len"] = torch.as_tensor(lens.astype(np.int32), device=device)
    f["term"] = torch.as_tensor(rng.rand(E) > 0.5, device=device)
    f["v_trunc"] = tm(rng.randn(E))
    f["mean"] = torch.full((), 0.3, device=device)
    f["scale"] = torch.full((), 1.7, device=device)
    return f


def moved_bytes(entry: str, mode: str, L1: int, lens, select=None,
                zero_unselected: bool = False) -> int:
    """Bytes the function must move for these inputs. Per computed slot
    of length T: F fields (4 for Retrace, 2 for GAE) at t = 1..T, its
    length (4 B) and terminal flag (1 B); every written row has L1
    elements. The sweep adds v_trunc (4 B) per computed slot, the select
    flag (1 B) per slot and the two reward scalars."""
    E = lens.numel()
    if entry == "affine_suffix_scan":
        return 3 * E * L1 * 4
    n_fields = 2 if mode == "GAE" else 4
    if entry == "batched_retrace":
        return (n_fields * int(lens.sum()) + E * L1) * 4 + 5 * E
    n_sel = int(select.sum())
    rows = E if zero_unselected else n_sel
    return ((n_fields * int(lens[select].sum()) + rows * L1) * 4
            + 9 * n_sel + E + 8)


def _cases(device):
    """(entry, mode, case, kernel call, loop call or None, bytes)."""
    E, L1 = MAIN_E, MAIN_L1
    rng = np.random.RandomState(1)
    some = np.zeros(E, bool)
    some[rng.permutation(E)[:INGEST_SELECTED]] = True
    out = []
    near = np.arange(E) < INGEST_SELECTED
    for case in ("random", "full", "sorted"):
        f = replay_fields(0, E, L1, case, device)
        every = torch.ones(E, dtype=torch.bool, device=device)
        picks = [("", every, True)]
        if case == "random":
            picks.append(("ingest", torch.as_tensor(some, device=device),
                          False))
            picks.append(("ingest neighbours",
                          torch.as_tensor(near, device=device), False))
            a, b = f["r"].t(), f["b"].t()
            out.append(("affine_suffix_scan", "-", "all steps",
                        lambda a=a, b=b, **kw: rk.affine_suffix_scan(
                            a, b, **kw),
                        True, moved_bytes("affine_suffix_scan", "-", L1,
                                          f["len"])))
        for mode in ("retrace", "GAE"):
            if case == "sorted" and mode == "GAE":
                continue
            args = (f["r"].t(), f["v"].t(), f["adv"].t(), f["rho"].t(),
                    f["len"], f["term"], GAMMA, LAM, mode)
            out.append(("batched_retrace", mode, case,
                        lambda args=args, **kw: rk.batched_retrace(
                            *args, **kw),
                        True, moved_bytes("batched_retrace", mode, L1,
                                          f["len"])))
            for tag, select, zero in picks if case != "sorted" else ():
                sargs = (f["qret"], f["r"], f["v"], f["adv"], f["rho"],
                         f["v_trunc"], f["len"], f["term"], select,
                         f["mean"], f["scale"], GAMMA, LAM, mode, zero)
                out.append(("retrace_sweep", mode, tag or case,
                            lambda sargs=sargs: rk.retrace_sweep_(*sargs),
                            False, moved_bytes("retrace_sweep", mode, L1,
                                               f["len"], select, zero)))
    return out


def measure(device, n: int = 50):
    """One row per (entry point, mode, case): dicts with `ms` (the
    pipeline), `loop_ms` (the plain device loop, None for the sweep),
    `bytes`, `bound_ms`, `share_of_bound` and `clone_ms`."""
    timer = ColdTimer(device)
    rows = []
    for entry, mode, case, call, has_loop, nbytes in _cases(device):
        src = torch.empty(nbytes // 8, dtype=torch.float32, device=device)
        ms = timer(call, n)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "entry": entry, "mode": mode, "case": case, "ms": ms,
            "loop_ms": timer(lambda: call(pipelined=False), n)
            if has_loop else None,
            "bytes": nbytes, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / ms,
            "clone_ms": timer(src.clone, n)})
    return rows


def measure_sweep_at(device, E: int, L1: int, mode: str, n: int = 30):
    """The sweep over every slot (random lengths) at another path's
    replay shape and mode: a row like `measure`'s, with the plain torch
    version's `plain_ms` instead of the device loop's."""
    timer = ColdTimer(device)
    f = replay_fields(0, E, L1, "random", device)
    every = torch.ones(E, dtype=torch.bool, device=device)
    sargs = (f["qret"], f["r"], f["v"], f["adv"], f["rho"], f["v_trunc"],
             f["len"], f["term"], every, f["mean"], f["scale"], GAMMA, LAM,
             mode, True)
    nbytes = moved_bytes("retrace_sweep", mode, L1, f["len"], every, True)
    ms = timer(lambda: rk.retrace_sweep_(*sargs), n)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    src = torch.empty(nbytes // 8, dtype=torch.float32, device=device)
    return {"entry": "retrace_sweep", "mode": mode, "case": "random",
            "shape": [E, L1], "ms": ms, "bytes": nbytes,
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
            "clone_ms": timer(src.clone, n),
            "plain_ms": timer(lambda: ret.retrace_sweep_plain_(*sargs),
                              max(3, n // 6))}


def launch_floor_ms(device, n: int = 50) -> float:
    """Median ms of a sweep launch that selects no slot, so every block
    leaves at once: what the timer reads for a kernel that does no work
    (the launch and the two event records)."""
    f = replay_fields(0, MAIN_E, MAIN_L1, "random", device)
    none = torch.zeros(MAIN_E, dtype=torch.bool, device=device)
    return ColdTimer(device)(lambda: rk.retrace_sweep_(
        f["qret"], f["r"], f["v"], f["adv"], f["rho"], f["v_trunc"],
        f["len"], f["term"], none, f["mean"], f["scale"], GAMMA, LAM,
        "retrace", False), n)


def plain_ms(device, n: int = 10):
    """Median ms of each entry point's plain torch version at the
    `random` Retrace case (the plain loops launch thousands of small
    kernels, so their time follows the host)."""
    timer = ColdTimer(device)
    E, L1 = MAIN_E, MAIN_L1
    f = replay_fields(0, E, L1, "random", device)
    every = torch.ones(E, dtype=torch.bool, device=device)
    args = (f["r"].t(), f["v"].t(), f["adv"].t(), f["rho"].t(), f["len"],
            f["term"], GAMMA, LAM, "retrace")
    sargs = (f["qret"], f["r"], f["v"], f["adv"], f["rho"], f["v_trunc"],
             f["len"], f["term"], every, f["mean"], f["scale"], GAMMA, LAM,
             "retrace", True)
    return {
        "affine_suffix_scan": timer(lambda: ret.affine_suffix_scan_plain(
            f["r"].t(), f["b"].t()), n),
        "batched_retrace": timer(lambda: ret.batched_retrace_plain(*args),
                                 n),
        "retrace_sweep": timer(lambda: ret.retrace_sweep_plain_(*sargs), n)}


def format_row(r) -> str:
    loop = "-" if r["loop_ms"] is None else f"{r['loop_ms']:.4f}"
    return (f"{r['entry']} {r['mode']} {r['case']}: kernel {r['ms']:.4f} ms"
            f" | plain device loop {loop} ms | {r['bytes']} B, bound "
            f"{r['bound_ms'] * 1e3:.2f} us, share of bound "
            f"{r['share_of_bound']:.3f} | clone of as many bytes "
            f"{r['clone_ms']:.4f} ms")


def ptxas_lines():
    """Per kernel of the last build: registers, spills and stack as
    ptxas reported them (empty when the library was already built), then
    the dynamic shared memory a pipelined block asks for."""
    out, name = [], None
    for ln in rk.build_info["log"].splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                      r"(?:ILb(\d)ELb(\d)EE)?", ln)
        if m:
            name = m.group(1) + (f"<sweep={m.group(2)}, gae={m.group(3)}>"
                                 if m.group(2) else "")
        elif "spill" in ln or "registers" in ln:
            out.append(f"{name}: {ln.replace('ptxas info    :', '').strip()}")
    lib = rk.library()
    out.append("dynamic shared memory per pipelined block: "
               f"{lib.smt_pipeline_smem_bytes(4)} B with 4 fields (Retrace), "
               f"{lib.smt_pipeline_smem_bytes(2)} B with 2 (GAE, affine)")
    return out


def tune(device):
    """`batched_retrace` (Retrace; random and full lengths) under other
    pipeline shapes, each its own build; the default comes first."""
    timer = ColdTimer(device)
    calls = [(c[2], c[3]) for c in _cases(device)
             if c[0] == "batched_retrace" and c[1] == "retrace"]
    shapes = (None,) + TUNE_SHAPES
    try:
        for shape in shapes:
            defines = () if shape is None else (
                f"SMT_PRODUCERS={shape[0]}", f"SMT_STEPS={shape[1]}",
                f"SMT_STAGES={shape[2]}")
            rk._lib = rk.build(defines)
            times = ", ".join(f"{case} {timer(call, 30):.4f} ms"
                              for case, call in calls)
            print(f"tune {'default' if shape is None else shape} "
                  f"(producer warps, steps per producer and tile, stages): "
                  f"{times}",
                  flush=True)
    finally:
        rk._lib = None


def main():
    if not torch.cuda.is_available():
        print("bench_retrace: needs a CUDA card", file=sys.stderr)
        sys.exit(2)
    print(card_line(), flush=True)
    device = torch.device("cuda")
    rk.library()
    print(f"nvcc {rk.build_info['seconds']} s", flush=True)
    for line in ptxas_lines():
        print(f"  ptxas: {line}", flush=True)
    for row in measure(device):
        print(format_row(row), flush=True)
    print(f"a launch that selects no slot: {launch_floor_ms(device):.4f} ms",
          flush=True)
    for name, ms in plain_ms(device).items():
        print(f"plain torch version, {name} retrace random: {ms:.4f} ms",
              flush=True)
    if "--tune" in sys.argv[1:]:
        tune(device)


if __name__ == "__main__":
    main()

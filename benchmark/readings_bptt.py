"""The readings that the limits of `correct` are set from for a cell of
the fused_bptt mix (benchmark/readings.py's, through the train_bptt
driver): for each seed, the cell's set-up and its checked steps, then
the compared numbers of the program, of the control (the reference in
float32 with TF32 on, in the program's place) and of the half-batch
fault (the reference on the first half of each batch). One JSON line per
seed.

    python -m benchmark.readings_bptt --workload racer_rnn_cartpole.fused \\
        --seeds 11 12 13 [--fault short_window]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import faults_bptt, harness
from benchmark.drivers import program, train_bptt


def readings(name: str, seed: int, options: dict | None = None,
             man: dict | None = None) -> dict:
    """One seed's readings; man: the manifest (BENCHMARK.json's)."""
    options = dict(options or {})
    files = harness.cell_files(man or harness.manifest(), name)
    if options.get("device", "cuda") == "cuda":
        harness.check_card(files["cell"]["chips"])
    ref = harness.reference_module(files["config_name"])
    s = train_bptt.Setup(files, ref, seed, options)
    snap, arch = s.snap, s.arch
    del s
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    out = train_bptt.control(snap, ref, arch,
                             program.settings(files, options.get("sizes")))
    return {"seed": seed, **out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.readings_bptt")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=faults_bptt.NAMES, default=None,
                   help="plant this fault in the program first")
    args = p.parse_args(argv)
    if args.fault:
        faults_bptt.plant(args.fault)
    for seed in args.seeds:
        print(json.dumps({"fault": args.fault,
                          **readings(args.workload, seed)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

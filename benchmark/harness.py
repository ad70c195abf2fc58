"""One run of one cell: find its files by name, check the card, run the
mix's driver, read the per-layer metrics, judge `correct`, print the
line.

A run imports nothing whose top-level module name is jax, jaxlib, flax
or smarties_tpu (the JAX package; compared by whole top-level name,
since smarties_tpu_torch begins with it): it checks sys.modules once its
window has closed and fails, printing no result, if it finds one.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "smarties_tpu")


class RunError(Exception):
    """A run that cannot give a result (no card, a missing file)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise RunError(f"no BENCHMARK.json in {root}")
    return load_json(path)


def cell_files(man: dict, name: str, root: str = ROOT) -> dict:
    """The cell's entry and its configuration, mix, limits and metric
    entries, found by name under `root`."""
    here = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise RunError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    limits = os.path.join(here, "limits", name + ".json")
    configs = {c["name"]: c for c in man["configs"]}
    entry = configs[cell["config"]]
    return {
        "cell": cell,
        "config": load_json(os.path.join(root, entry["file"])),
        "config_name": cell["config"],
        "mix": load_json(os.path.join(here, "mixes",
                                      cell["traffic"] + ".json")),
        # a cell without its limits file (yet) can still be read for them
        "limits": (load_json(limits) if os.path.exists(limits) else {}),
        "end_to_end": [m for m in man["end_to_end"] if reports(m, name)],
        "per_layer": [m for m in man["per_layer"] if reports(m, name)],
    }


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metric_reader(name: str, root: str = ROOT):
    """metrics/<name>.py's read(ctx) -> value or None."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference_module(config_name: str):
    return importlib.import_module("benchmark.reference." + config_name)


def check_card(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise RunError("CUDA is not available: this benchmark measures the "
                       "card and has no CPU fallback")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are here")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def judge(checks: list) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(not math.isnan(v) and v <= lim for _, v, lim in checks)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             options: dict | None = None, root: str = ROOT,
             man: dict | None = None) -> dict:
    """One run -> the result line's object. options (the tests' only):
    "device" ("cpu" skips the look for a card), "sizes" (overrides of
    the configuration's sizes and settings), "graphs", "warm_s" (in
    place of the mix's), "event" (a timing event in place of
    torch.cuda.Event). root: the checkout whose BENCHMARK.json and
    benchmark/ files are read; man: a manifest in place of its
    BENCHMARK.json (the tests')."""
    options = dict(options or {})
    files = cell_files(man or manifest(root), name, root)
    if options.get("device", "cuda") == "cuda":
        check_card(files["cell"]["chips"])
    driver = importlib.import_module(
        "benchmark.drivers." + files["mix"]["driver"])
    out = driver.run(files, reference_module(files["config_name"]), seed,
                     seconds, trace, options, T_START)
    metrics = {}
    if trace:
        for m in files["per_layer"]:
            v = metric_reader(m["name"], root)(out["ctx"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    missing = set(out["numbers"]) - set(files["limits"])
    if missing:
        raise RunError(f"no limit for {sorted(missing)} in limits/{name}.json")
    checks = [(n, v, files["limits"][n]) for n, v in out["numbers"].items()]
    line = {"correct": judge(checks) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"]}
    if trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in checks}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run imported {', '.join(found)}; it must "
              f"import neither JAX nor the JAX package", file=sys.stderr)
        return 4
    for n, c in line["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

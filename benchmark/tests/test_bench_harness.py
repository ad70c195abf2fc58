"""The benchmark's harness on the CPU: the manifest against the
contract's rules, a cell added from new files alone, the metric
arithmetic, and the import rules."""
from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness, trace, yardstick
from benchmark.tests import _tiny

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_follows_the_rules():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    assert 1 <= man["run_seconds"] <= 51
    names = [c["name"] for c in man["configs"]]
    cells = [w["name"] for w in man["workloads"]]
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for n in names + cells + metrics:
        assert NAME.match(n), n
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "metrics", m["name"] + ".py"))
    for c in man["configs"]:
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        files = harness.cell_files(man, w["name"])
        e2e_here = [m["name"] for m in files["end_to_end"]]
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        assert files["per_layer"]
        harness.reference_module(w["config"])


def test_the_checked_numbers_have_limits():
    """Each cell's limits file names exactly the numbers its run
    compares (a tiny run's numbers)."""
    man = _tiny.manifest()
    for cell in (w["name"] for w in man["workloads"]):
        line = harness.run_cell(cell, 5, 0.0, False, _tiny.options(cell),
                                man=man)
        files = harness.cell_files(man, cell)
        assert set(line["checks"]) == set(files["limits"])


def test_a_cell_from_new_files_alone(tmp_path):
    """A copy of the checkout with one more cell, mix, limits file and
    per-layer metric, all new files and entries: the harness runs it."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = harness.manifest()
    cell = "vracer_cartpole.dummy"
    man["workloads"].append({"name": cell, "config": "vracer_cartpole",
                             "traffic": "dummy", "chips": 1,
                             "why": "a test's cell"})
    for m in man["end_to_end"]:
        if "workloads" in m and "grad_steps_per_s" == m["name"]:
            m["workloads"].append(cell)
    man["per_layer"].append({"name": "dummy.cycles", "unit": "cycles",
                             "better": "higher", "source": "program_span",
                             "layer": "rollout", "moves": "grad_steps_per_s",
                             "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    b = tmp_path / "benchmark"
    (b / "mixes" / "dummy.json").write_text(json.dumps(
        {"driver": "train_fused", "settings": {"obsPerStep": 2.0},
         "why": "half the grad steps of fused"}))
    shutil.copy(b / "limits" / "vracer_cartpole.fused.json",
                b / "limits" / f"{cell}.json")
    (b / "metrics" / "dummy.cycles.py").write_text(
        "def read(ctx):\n    return ctx['spans']['ROLL'][1]\n")
    opts = _tiny.options(cell)
    line = harness.run_cell(cell, 9, 0.0, False, opts, root=str(tmp_path))
    assert line["correct"] and set(line["metrics"]) == {
        "grad_steps_per_s", "setup_s"}
    line = harness.run_cell(cell, 9, 0.0, True, opts, root=str(tmp_path))
    assert line["correct"] and line["metrics"]["dummy.cycles"]["value"] >= 1
    assert "train.k1_roofline" not in line["metrics"]   # no card


def test_mfu_k1_bytes_and_busy_time():
    read = harness.metric_reader
    ctx = {"grad_steps": 1000, "flops_per_step": 67e9, "window_s": 2.0,
           "peaks": yardstick.PEAKS["NVIDIA H100 80GB HBM3"],
           "spans": {}}
    assert read("train.mfu")(ctx) == pytest.approx(50.0)
    # [4096, 501] Retrace over every slot, lengths 1..4096 % 500
    import numpy as np
    lens = (np.arange(4096) % 500).astype(np.int64)
    every = np.ones(4096, bool)
    n = yardstick.k1_sweep_bytes("retrace", 501, lens, every, True)
    assert n == (4 * int(lens.sum()) + 4096 * 501) * 4 + 9 * 4096 + 4096 + 8
    some = np.zeros(4096, bool)
    some[:10] = True
    assert yardstick.k1_sweep_bytes("retrace", 501, lens, some, False) == (
        (4 * int(lens[:10].sum()) + 10 * 501) * 4 + 90 + 4096 + 8)
    # kernels over [0, 100] us: busy 0-10, 5-20 and 50-60: 30 of 100
    tr = {"kernels": [("a", 0, 10), ("b", 5, 20), ("K1 retrace", 50, 60)],
          "window": (0, 100)}
    assert trace.busy_us(tr) == 30 and trace.window_us(tr) == 100
    spans = {"ROLL": (0.5, 2), "TRAIN": (8.0, 2), "REFRESH": (0.5, 2)}
    assert read("train.gap_share")({"spans": spans, "window_s": 10.0}) == \
        pytest.approx(10.0)
    ctx.update(trace=tr, k1_bytes=3.35e12 * 5e-6)   # 5 us of bytes in 10
    assert read("train.k1_roofline")(ctx) == pytest.approx(50.0)
    b = trace.breakdown(tr)
    assert b["idle_gaps"][0] == ["end", 40e-6]
    assert b["idle_gaps"][1] == ["before K1 retrace", 30e-6]
    assert read("train.k1_roofline")({**ctx, "k1_bytes": 0}) is None
    assert yardstick.spread([1, 2, 3, 4, 5]) == pytest.approx(3.0 / 3.0)


def test_forbidden_modules_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "smarties_tpu_torch_like", sys)
    assert "smarties_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "smarties_tpu.fake", sys)
    assert "smarties_tpu" in harness.forbidden_modules()


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_the_references_import_no_program_and_no_jax():
    ref_dir = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref_dir):
        if f.endswith(".py"):
            found = set(_imports(os.path.join(ref_dir, f)))
            assert not found & {"jax", "jaxlib", "flax", "smarties_tpu",
                                "smarties_tpu_torch"}, f


def test_a_run_imports_no_jax(tmp_path):
    """A whole tiny run in a fresh interpreter leaves neither JAX nor the
    JAX package in sys.modules."""
    code = ("import json, sys\n"
            "from benchmark import harness\n"
            "from benchmark.tests import _tiny\n"
            "c = 'vracer_cartpole.fused'\n"
            "harness.run_cell(c, 3, 0.0, False, _tiny.options(c))\n"
            "print(json.dumps(harness.forbidden_modules()))\n")
    env = {k: v for k, v in os.environ.items()}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_card_no_result(tmp_path):
    """Without CUDA the command prints no result and fails; in a
    directory without the program it fails as well."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "benchmark", "--workload",
           "vracer_cartpole.fused", "--seed", "2147483659", "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env["PYTHONPATH"] = ""
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""

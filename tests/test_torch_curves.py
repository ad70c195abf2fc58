"""The port's learning-curve tool (smarties_tpu_torch/tools/learning_curves.py)
against the JAX package's (tools/learning_curves.py), on the CPU.

The port keeps its own copy of COMBOS: it must equal the JAX table.
Every combo then builds and trains on the CPU at a tiny size, cut through
train_combo's arguments (COMBOS is never changed): 16 envs, 64 replay
slots, episodes truncated at 16 steps, minTotObsNum 256 (16 blind
sweeps, so every lane ends an episode), maxTotObsNum 1024, batch 16, and
a budget of one grad step, which runs one fused cycle (16 grad steps) or
one PPO horizon. finish_combo must write rewards rows of the reference's
five columns [grad-step env-step agentID ep-length return] and a
summary.json holding every key of the JAX summary (the tracked
docs/curves/runs/<name>/summary.json) and the port's own. K1 launches
nothing on the CPU (its wrapper runs the plain version there), so the
counts by site are 0 while each site's calls are counted.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from smarties_tpu_torch.tools import learning_curves as lc

import _torch_parity  # noqa: F401  (torch at 1 thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(budget=1, n_envs=16, n_slots=64, max_len=16,
            settings={"minTotObsNum": 256, "maxTotObsNum": 1024,
                      "batchSize": 16})
PORT_KEYS = ("device", "power_limit", "budget", "wall_cap_s", "stopped_by",
             "cuts", "deviations", "k1_launches", "k1_calls",
             "k1_launches_by_entry", "replay")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_learning_curves", os.path.join(REPO, "tools",
                                            "learning_curves.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_combos_equal_reference():
    assert lc.COMBOS == _jax_tool().COMBOS


@pytest.mark.parametrize("name", sorted(lc.COMBOS))
def test_combo_tiny(name, tmp_path):
    tr = lc.train_combo(name, "cpu", out=str(tmp_path), **TINY)
    s = lc.finish_combo(name, tr)
    run_dir = tmp_path / name
    rows = np.loadtxt(run_dir / lc.REWARDS, ndmin=2)
    assert rows.shape[0] >= 1 and rows.shape[1] == 5, rows.shape
    assert (rows[:, 1] > 0).all() and (rows[:, 3] >= 1).all()
    assert np.isfinite(rows).all()
    on_disk = json.loads((run_dir / "summary.json").read_text())
    assert on_disk == json.loads(json.dumps(s))
    ref = json.loads(open(os.path.join(lc.REF, name,
                                       "summary.json")).read())
    assert set(ref) <= set(s), set(ref) - set(s)
    assert set(PORT_KEYS) <= set(s)
    c = lc.COMBOS[name]
    assert (s["name"], s["recipe"], s["env"]) == (name, c["recipe"],
                                                  c["env"])
    assert s["stopped_by"] == "budget" and s["grad_steps"] >= 1
    assert s["episodes"] == rows.shape[0]
    assert np.isfinite(s["eval_mean"]) and np.isfinite(s["eval_std"])
    assert s["device"] == "cpu" and s["power_limit"] is None
    assert s["cuts"] == TINY and s["wall_cap_s"] == c["wall"]
    assert s["replay"] == [64, 17]
    # a combo with nnBf16 (racer_catch) runs in bf16, as the JAX tool's
    assert s["deviations"] == []
    assert tr.cfg.nnBf16 == bool(c["over"].get("nnBf16"))
    assert s["k1_calls"]["ingest"] >= 1
    assert s["k1_calls"]["initialize_stats"] == 1
    assert set(s["k1_launches"].values()) == {0}
    assert set(s["k1_launches_by_entry"].values()) == {0}

"""The port's learning-record tools beside the learning-curve runs, on the
CPU: `compare` and `render` of smarties_tpu_torch/tools/learning_curves.py,
the command line's refusals, the CMA record (cma_func_max_record.py), the
LSTM endurance run (lstm_endurance.py) and the checkpoint.pt weight viewer
(plot_weights.py) against the JAX package's bin/smarties_tpu_plot_weights.py.

- compare on a tracked reference trace against itself gives equal means,
  at its last env-step count and at half of it; on a prefix of it, the
  reference's window ends at the prefix's last env-step count.
- The CMA record runs 3 generations over 8 forked apps/func_maximization
  apps and writes every key of the JAX record's summary.json and its
  curve rows [generation, avgR].
- The endurance run reads LSTM_BUDGET and runs at a tiny size (16 envs,
  one fused cycle), writing the JAX summary's keys but
  worker_crash_retries (the TPU crash-retry path is not ported).
- The viewers: a JAX Trainer's checkpoint.pkl (its params and Adam
  moments) and a port Trainer's checkpoint.pt holding the same values,
  carried across by models/convert.py, print the same per-leaf lines
  (the same f32 values, so the printed text is equal).
"""
import contextlib
import importlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from smarties_tpu_torch.tools import cma_func_max_record as cmarec
from smarties_tpu_torch.tools import learning_curves as lc
from smarties_tpu_torch.tools import plot_weights

import _torch_parity  # noqa: F401  (torch at 1 thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_envs=16, n_slots=64, max_len=16,
            settings={"minTotObsNum": 256, "maxTotObsNum": 1024,
                      "batchSize": 16})
RECORDED = ("ppo_std_cartpole", "ppo_cartpole", "vracer_cma_cartpole",
            "racer_catch", "acer_cartpole", "dqn_cartpole")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", RECORDED)
def test_compare_reference_against_itself(name):
    res = lc.compare(name, out=lc.REF, ref=lc.REF)
    assert res["port_mean"] == res["reference_mean"]
    assert res["port_episodes"] == res["reference_episodes"] \
        == lc.COMPARE_WINDOW
    half = lc.compare(name, out=lc.REF, ref=lc.REF,
                      at=res["env_steps"] // 2)
    assert half["env_steps"] == res["env_steps"] // 2
    assert half["port_mean"] == half["reference_mean"]


def test_compare_prefix_window(tmp_path):
    name = "ppo_std_cartpole"
    ref = os.path.join(lc.REF, name, lc.REWARDS)
    rows = np.loadtxt(ref)
    rows = rows[np.argsort(rows[:, 1], kind="stable")]
    cut = rows[rows[:, 1] <= rows[len(rows) // 3, 1]]
    os.makedirs(tmp_path / name)
    np.savetxt(tmp_path / name / lc.REWARDS, cut, fmt="%g")
    res = lc.compare(name, out=str(tmp_path), ref=lc.REF, window=50)
    assert res["env_steps"] == int(cut[-1, 1])
    np.testing.assert_allclose(res["port_mean"], cut[-50:, 4].mean())
    np.testing.assert_allclose(res["reference_mean"], cut[-50:, 4].mean())
    assert len(cut) < len(rows)


def test_render_draws_port_and_reference(tmp_path):
    for name in ("ppo_cartpole", "racer_catch"):
        shutil.copytree(os.path.join(lc.REF, name), tmp_path / name)
    lc.render(out=str(tmp_path), ref=lc.REF)
    for png in ("ppo_cartpole.png", "racer_catch.png", "summary.png"):
        assert (tmp_path / png).stat().st_size > 0, png


def test_cli_refuses_cpu_and_unknown_combo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = [sys.executable, "-m", "smarties_tpu_torch.tools.learning_curves"]
    out = subprocess.run(cmd + ["run", "ppo_cartpole", "--budget", "1",
                                "--out", str(tmp_path)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr, out.stderr[-2000:]
    assert not os.path.exists(tmp_path / "ppo_cartpole" / "summary.json")
    out = subprocess.run(cmd + ["run", "no_such_combo", "--device", "cpu"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and "no_such_combo" in out.stderr


def test_cma_record_generations(tmp_path):
    s = cmarec.record("cpu", 3, str(tmp_path))
    ref = json.loads(open(os.path.join(lc.REF, "cma_func_max",
                                       "summary.json")).read())
    assert set(ref) <= set(s), set(ref) - set(s)
    assert json.loads((tmp_path / "summary.json").read_text()) == s
    curve = json.loads((tmp_path / "curve.json").read_text())
    assert [g for g, _ in curve] == [1, 2, 3] and s["generations"] == 3
    assert np.isfinite([r for _, r in curve]).all()
    assert s["final_avg_return"] == curve[-1][1]
    assert len(s["proposed_x"]) == s["dim"] == 4
    assert np.isfinite(s["final_objective"])
    assert s["solved"] == (s["final_objective"] < 1e-3)
    assert s["device"] == "cpu"


def test_lstm_endurance_tiny(tmp_path, monkeypatch):
    from smarties_tpu_torch.tools import lstm_endurance
    monkeypatch.setenv("LSTM_BUDGET", "1")
    endurance = importlib.reload(lstm_endurance)
    try:
        assert endurance.BUDGET == 1
        s = endurance.run("cpu", str(tmp_path), **TINY)
    finally:
        monkeypatch.delenv("LSTM_BUDGET")
        importlib.reload(lstm_endurance)
    ref = json.loads(open(os.path.join(
        lc.REF, "racer_rnn_endurance", "summary.json")).read())
    ref.pop("worker_crash_retries", None)
    assert set(ref) <= set(s), set(ref) - set(s)
    assert s["name"] == "racer_rnn_endurance"
    assert s["recipe"] == "RACER_RNN" and s["env"] == "cartpole.pomdp"
    assert s["completed_unattended"] and s["stopped_by"] == "budget"
    assert s["wall_cap_s"] is None and np.isfinite(s["eval_mean"])
    rows = np.loadtxt(tmp_path / lc.REWARDS, ndmin=2)
    assert rows.shape[1] == 5 and len(rows) == s["episodes"] >= 1


def test_weight_viewers_agree(tmp_path):
    import jax
    from smarties_tpu.envs import cartpole as jcartpole
    from smarties_tpu.runtime.trainer import Trainer as JTrainer
    from smarties_tpu.utils.config import HyperParameters as JHP
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.models import convert
    from smarties_tpu_torch.models.net import tree_map
    from smarties_tpu_torch.runtime.trainer import Trainer
    from smarties_tpu_torch.utils.config import HyperParameters

    d = dict(nnLayerSizes=[16, 8], batchSize=16, minTotObsNum=256,
             maxTotObsNum=1024)
    jtr = JTrainer(jcartpole, jcartpole.MDP, JHP.from_dict(d), n_envs=8,
                   n_slots=64, max_len=32)
    # moments as a trained state holds them
    rng = np.random.RandomState(0)
    rand = lambda x: np.asarray(rng.randn(*np.shape(x)), np.float32)
    opt = jtr.opt_state
    jtr.opt_state = opt._replace(
        m1=jax.tree_util.tree_map(rand, opt.m1),
        m2=jax.tree_util.tree_map(lambda x: np.abs(rand(x)), opt.m2))
    jtr.save(str(tmp_path / "checkpoint.pkl"))

    tr = Trainer(cartpole, cartpole.MDP, HyperParameters.from_dict(d),
                 n_envs=8, n_slots=64, max_len=32, device="cpu")
    params_np = jax.tree_util.tree_map(np.asarray, jtr.params)
    with torch.no_grad():
        tree_map(lambda dst, src: dst.copy_(src), tr.params,
                 convert.params_from_jax(params_np))
    tr.opt_state = convert.opt_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jtr.opt_state))
    tr.save(str(tmp_path / "checkpoint.pt"))

    jview = _load(os.path.join(REPO, "bin", "smarties_tpu_plot_weights.py"),
                  "jax_plot_weights")
    texts = []
    for view, path in ((jview, "checkpoint.pkl"),
                       (plot_weights, "checkpoint.pt")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _run_main(view, str(tmp_path / path))
        texts.append(buf.getvalue().splitlines())
    jtext, ptext = texts
    assert jtext[:2] == ptext[:2] == [
        "== learner 0 ==", f"{'leaf':<28s} {'shape':>14s} {'|w|max':>10s} "
        f"{'rms':>10s}"]
    assert sorted(jtext) == sorted(ptext)
    assert len(ptext) == 3 + len(jax.tree_util.tree_leaves(jtr.params))
    assert ptext[-1].startswith("n=") and "|m1|max=" in ptext[-1]


def _run_main(view, path):
    """A viewer's main() on `path` as its command line (the JAX viewer
    reads sys.argv only)."""
    argv = sys.argv
    sys.argv = ["plot_weights", path]
    try:
        view.main()
    finally:
        sys.argv = argv


def test_weight_viewer_engine_checkpoint(tmp_path):
    """An Engine's checkpoint.pt lists its learners; each gets a block."""
    g = torch.Generator().manual_seed(0)
    learner = lambda: {"params": {"layers": [{"W": torch.randn(3, 4,
                                                               generator=g),
                                              "b": torch.zeros(4)}]},
                       "opt_state": {"m1": {"layers": [{
                           "W": torch.ones(3, 4), "b": torch.ones(4)}]},
                           "m2": {"layers": [{"W": torch.ones(3, 4),
                                              "b": torch.ones(4)}]}}}
    torch.save({"learners": [learner(), learner()], "n_grad_steps": 0},
               tmp_path / "checkpoint.pt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        plot_weights.main([str(tmp_path / "checkpoint.pt")])
    text = buf.getvalue().splitlines()
    assert [t for t in text if t.startswith("==")] == [
        "== learner 0 ==", "== learner 1 =="]
    assert sum(t.startswith("layers.0.W ") for t in text) == 2
    assert sum(t.startswith("n=16 ") for t in text) == 2

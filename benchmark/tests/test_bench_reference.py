"""The plain references against the port at a tiny size on the CPU, the
runs that must come out not correct (the timed path broken underneath),
and the control on the card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import faults, harness, readings
from benchmark.reference import cartpole
from benchmark.tests import _tiny

CELL = "vracer_cartpole.fused"


def test_the_port_agrees_with_the_reference_at_a_tiny_size():
    line = harness.run_cell(CELL, 2147483659, 0.0, False,
                            _tiny.options(CELL))
    assert line["correct"], line["checks"]
    assert line["metrics"]["grad_steps_per_s"]["value"] > 0


def test_the_env_reference_follows_the_ports_env_step():
    from smarties_tpu_torch.envs import cartpole as pc
    g = torch.Generator().manual_seed(0)
    s = pc.init(g, 4)
    u = s.u.double().numpy()
    a = torch.linspace(-1, 1, 4)[:, None]
    s1, r, d, _ = pc.step(s, 10 * torch.tanh(a))
    ref = cartpole.advance(u, 10 * np.tanh(a.double().numpy()[:, 0]))
    assert np.abs(ref - s1.u.double().numpy()).max() < 1e-6


BROKEN = ([(CELL, f) for f in faults.NAMES if f != "draw_altered"]
          + [("vracer_cartpole.perrank", f) for f in (
              "state_unchanged", "half_batch", "draw_altered")])


@pytest.mark.parametrize("cell,how", BROKEN)
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, how):
    faults.plant(how, monkeypatch.setattr)
    line = harness.run_cell(cell, 77, 0.0, False, _tiny.options(cell),
                            man=_tiny.manifest())
    assert not line["correct"], line["checks"]


@pytest.mark.cuda
def test_the_control_fails_on_the_card():
    """The reference in float32 with TF32 on, in the program's place,
    fails one of the cell's limits on three seeds; the program does not
    (a small replay; the cell's own widths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    files = harness.cell_files(harness.manifest(), CELL)
    opts = {"sizes": {"n_envs": 256, "n_slots": 1024, "fill_env_steps": 8192,
                      "settings": {"minTotObsNum": 4096}}}
    for seed in (3, 4, 5):
        r = readings.readings(CELL, seed, opts)
        lim = files["limits"]
        assert all(v <= lim[k] for k, v in r["program"].items()), r
        assert any(v > lim[k] for k, v in r["tf32"].items()), r
        assert any(v > lim[k] for k, v in r["half_batch"].items()), r

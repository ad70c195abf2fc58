"""The cell racer_atari.fused on the CPU: catch's 84x84 frames, the
published conv stack and [512] layer, few envs and slots and a batch of
32 (benchmark/tests/conftest.py). The plain references against the
program, the cell's run, the runs that must come out not correct, and
the readers of the conv stack's metrics."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import conv_flops, faults, harness, yardstick
from benchmark.drivers import program
from benchmark.reference import catch as rcatch
from benchmark.reference import racer_atari as ref
from benchmark.tests import _tiny

CELL = "racer_atari.fused"
CONFIG = json.load(open(os.path.join(harness.ROOT, "benchmark", "configs",
                                     "racer_atari.json")))


def _learner():
    from smarties_tpu_torch.algos.vracer import VRacer
    from smarties_tpu_torch.envs import catch
    from smarties_tpu_torch.utils.config import HyperParameters
    cfg = HyperParameters.from_dict(CONFIG["settings"])
    return VRacer(catch.MDP, cfg)


def test_the_configuration_is_the_programs():
    """The stack the reference reads is the program's catch stack; the
    dense input, the outputs and the conv FLOPs of a step (10.21 GFLOP
    at batch 128) follow from the shapes."""
    from smarties_tpu_torch.envs import catch
    algo = _learner()
    arch = ref.arch(CONFIG)
    assert arch["conv"] == list(catch.CONV_STACK)
    assert arch["n_in"] == 7 * 7 * 64 and arch["hidden"] == [512]
    assert arch["n_out"] == algo.spec.n_out == 7
    assert conv_flops.step_conv_flops(arch["conv"], 256) == 10206838784
    macs = yardstick.dense_macs(arch["conv"], [arch["n_in"], 512, 7])
    assert sum(macs) * 2 * 256 * 3 - 2 * 256 * macs[0] == \
        yardstick.step_flops(arch["conv"], [arch["n_in"], 512, 7], 256, 256)


def test_the_reference_net_is_the_programs_net():
    """The reference's im2col forward and its gradients (float64) against
    the program's net (conv2d, HWIO leaves) in float64 on the same
    weights and standardised frames."""
    from smarties_tpu_torch.models.net import apply_net, init_params, \
        tree_map
    algo = _learner()
    params = init_params(torch.Generator().manual_seed(3), algo.spec)
    params = tree_map(lambda x: x.detach().double().requires_grad_(True),
                      params)
    g = torch.Generator().manual_seed(4)
    x = torch.randn((5, 4 * 84 * 84), generator=g, dtype=torch.float64)
    proj = torch.randn((5, 7), generator=g, dtype=torch.float64)
    y, _ = apply_net(params, algo.spec, x)
    leaves = program.program_leaves(params)
    gp = torch.autograd.grad((y * proj).sum(), list(leaves.values()))
    w = {k: v.requires_grad_(True) for k, v in
         program.read_tree(params, ref).items()}
    yr = ref.forward(w, ref.arch(CONFIG), x)
    torch.testing.assert_close(yr, y, rtol=1e-10, atol=1e-12)
    gr = torch.autograd.grad((yr * proj).sum(), list(w.values()))
    for name, a, b in zip(leaves, gp, gr):
        torch.testing.assert_close(ref.from_program(name, a), b,
                                   rtol=1e-9, atol=1e-12, msg=name)
    # the layouts go both ways
    for name, a in leaves.items():
        assert torch.equal(ref.to_program(name, ref.from_program(name, a)),
                           a)


def _episodes(n=6, seed=5, fall=None):
    """n whole episodes of the program's catch under random actions, in
    the stored layout (states [E, 40, H * W] uint8 ...). fall: the
    ball's rows a step, if not the game's."""
    from smarties_tpu_torch.envs import catch
    g = torch.Generator().manual_seed(seed)
    s = catch.init(g, n)
    L1 = catch.MAX_STEPS + 1
    states = np.zeros((n, L1, 84 * 84), np.uint8)
    actions = np.zeros((n, L1, 1))
    rewards = np.zeros((n, L1))
    states[:, 0] = catch.observe(s).numpy()
    for t in range(catch.MAX_STEPS):
        a = torch.randint(0, 3, (n, 1), generator=g)
        s1, r, d, term = catch.step(s, a)
        if fall is not None:
            s1 = s1._replace(ball_row=s.ball_row + fall)
        s = s1
        actions[:, t, 0] = a[:, 0].numpy()
        rewards[:, t + 1] = r.numpy()
        states[:, t + 1] = catch.observe(s).numpy()
    return states, actions, rewards, np.full(n, catch.MAX_STEPS), \
        term.numpy()


def test_the_catch_reference_is_exact_on_the_pixels():
    """The program's game passes with no wrong pixel or event; one
    changed pixel, a ball that falls 1 row a step (fields that shared
    memory) and a wrong reward each show."""
    st, ac, rw, ln, te = _episodes()
    assert te.all()
    assert rcatch.transition_gaps(st, ac, rw, ln, te) == (0, 0)
    bad = st.copy()
    bad[2, 17, 100] ^= 255
    assert rcatch.transition_gaps(bad, ac, rw, ln, te)[0] >= 1
    slow = _episodes(fall=1)
    assert rcatch.transition_gaps(*slow[:3], ln, te)[0] >= 8 * 39 * 6
    rw2 = rw.copy()
    rw2[1, 39] = -rw2[1, 39]
    assert rcatch.transition_gaps(st, ac, rw2, ln, te) == (0, 1)


def test_the_cell_is_correct_at_a_tiny_size():
    line = harness.run_cell(CELL, 2147483659, 0.0, False,
                            _tiny.options(CELL))
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"stats", "env_pixels", "env_events",
                                   "retrace", "loss", "grad", "change",
                                   "rho"}
    assert line["metrics"]["grad_steps_per_s"]["value"] > 0
    line = harness.run_cell(CELL, 7, 0.0, True, _tiny.options(CELL))
    assert line["correct"], line["checks"]
    m = line["metrics"]
    assert m["train.step_conv_ms"]["value"] > 0
    assert "train.conv_roofline" not in m          # no card, no peak


def _shared_fields(monkeypatch):
    """catch's state with ball_row and step in one tensor, and the
    Trainer's refusal of it taken away: the fault the cell was kept out
    for."""
    from smarties_tpu_torch.envs import catch
    from smarties_tpu_torch.runtime import trainer
    init = catch.init

    def shared(*a, **k):
        s = init(*a, **k)
        return s._replace(step=s.ball_row)

    monkeypatch.setattr(catch, "init", shared)
    monkeypatch.setattr(trainer, "refuse_shared_fields", lambda *a: None)


def _reward_altered(monkeypatch):
    from smarties_tpu_torch.envs import catch
    step = catch.step

    def altered(s, a, *rest):
        s1, r, d, term = step(s, a, *rest)
        return s1, r + 0.25, d, term

    monkeypatch.setattr(catch, "step", altered)


BROKEN = {"shared_fields": _shared_fields,
          "catch_reward_altered": _reward_altered}


@pytest.mark.parametrize("how", ["shared_fields", "catch_reward_altered",
                                 "half_batch", "state_unchanged",
                                 "returns_altered", "stats_altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, how):
    if how in BROKEN:
        BROKEN[how](monkeypatch)
    else:
        faults.plant(how, monkeypatch.setattr)
    line = harness.run_cell(CELL, 77, 0.0, False, _tiny.options(CELL))
    assert not line["correct"], line["checks"]
    if how == "shared_fields":
        assert line["checks"]["env_pixels"]["value"] > 0


def test_the_conv_metric_readers():
    step = harness.metric_reader("train.step_conv_ms")
    roof = harness.metric_reader("train.conv_roofline")
    peaks = yardstick.PEAKS["NVIDIA H100 80GB HBM3"]
    ctx = {"phases": {"phases_ms": {"gather": 0.1, "conv_forward": 0.5,
                                    "forward": 0.2, "conv_backward": 1.0}},
           "peaks": peaks, "conv_flops_per_step": 10.05e9}
    assert step(ctx) == pytest.approx(1.5)
    # 10.05 GFLOP in 1.5 ms: 6.7 TFLOP/s, a tenth of 67
    assert roof(ctx) == pytest.approx(10.0)
    dense = {"phases": {"phases_ms": {"forward": 0.2, "backward": 0.1}},
             "peaks": peaks, "conv_flops_per_step": 10.05e9}
    for c in (dense, {}, {"phases": {}}):
        assert step(c) is None and roof(c) is None
    assert step({**ctx, "peaks": None}) == pytest.approx(1.5)
    assert roof({**ctx, "peaks": None}) is None


def test_a_program_without_conv_phases_stops_before_set_up(monkeypatch):
    """The parent of this cell stamps no conv phases: its run stops at
    once with the harness's error, not after minutes of set-up."""
    from smarties_tpu_torch.algos import vracer
    monkeypatch.delattr(vracer, "CONV_STEP_PHASES")
    with pytest.raises(harness.RunError, match="conv phases"):
        harness.run_cell(CELL, 3, 0.0, False, _tiny.options(CELL))

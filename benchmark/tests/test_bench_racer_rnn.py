"""The cell racer_rnn_cartpole.fused on the CPU: the published LSTM [32,
32] and 16-step window, few envs and slots and a batch of 32. The plain
references against the program, the cell's run, the runs that must
come out not correct, and the readers of the recurrent window's
metrics."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmark import bptt_flops, faults_bptt, harness, readings_bptt
from benchmark.drivers import train_bptt
from benchmark.reference import lstm
from benchmark.reference import racer_rnn_cartpole as ref
from benchmark.tests import _tiny

CELL = "racer_rnn_cartpole.fused"
CONFIG = json.load(open(os.path.join(harness.ROOT, "benchmark", "configs",
                                     "racer_rnn_cartpole.json")))
_tiny.SIZES.setdefault("racer_rnn_cartpole", {
    "n_envs": 16, "n_slots": 64, "fill_env_steps": 1024,
    "settings": {"minTotObsNum": 512, "maxTotObsNum": 1024,
                 "batchSize": 32}})


def _learner():
    from smarties_tpu_torch.algos.vracer import VRacer
    from smarties_tpu_torch.envs import cartpole
    from smarties_tpu_torch.utils.config import HyperParameters
    cfg = HyperParameters.from_dict(CONFIG["settings"])
    return VRacer(cartpole.pomdp.MDP, cfg)


def test_the_configuration_is_the_programs():
    """The settings are the program's RACER_RNN recipe over the defaults;
    the net the reference reads is the learner's; a step's FLOPs from
    the shapes (157.7 MFLOP at batch 128, W = 16)."""
    from smarties_tpu_torch.utils.config import HyperParameters
    from smarties_tpu_torch.utils.recipes import RECIPES
    recipe = HyperParameters.from_dict(RECIPES["RACER_RNN"]).to_dict()
    cfg = HyperParameters.from_dict(CONFIG["settings"]).to_dict()
    # the recipe's "default" estimator is V-RACER's Retrace
    assert recipe.pop("returnsEstimator") == "default"
    assert cfg.pop("returnsEstimator") == "retrace"
    assert cfg == recipe
    algo = _learner()
    assert algo.returns_mode == "retrace"
    arch = ref.arch(CONFIG)
    spec = algo.spec
    assert (spec.kind, spec.hidden, spec.n_in) == ("LSTM", (32, 32), 3)
    assert arch["n_in"] == spec.n_in and arch["hidden"] == [32, 32]
    assert (arch["n_out"], arch["n_param"]) == (spec.n_out,
                                                spec.n_param_out) == (2, 1)
    assert CONFIG["settings"]["nnBPTTseq"] == 16 and CONFIG["reduced"] == []
    assert bptt_flops.step_flops("LSTM", 3, [32, 32], 2, 128, 16) == \
        157696000


def test_the_reference_net_is_the_programs_net():
    """The reference's window (float64) against the program's
    seq_forward_vjp (float32) at the published widths on the same
    weights and window: the outputs at t and t+1 and every leaf's
    gradient, with windows that start before their episode."""
    from smarties_tpu_torch.algos import base
    from smarties_tpu_torch.models.net import init_params
    algo = _learner()
    arch = ref.arch(CONFIG)
    g = torch.Generator().manual_seed(4)
    w = lstm.draw_weights(g, arch, ref.param_init(CONFIG))
    params = init_params(torch.Generator().manual_seed(3), algo.spec)
    train_bptt.write_weights(params, w)
    B, P = 7, 17
    xs = torch.randn((B, P, 3), generator=g)
    start = torch.tensor([0, 3, 9, 15, 16, 0, 0])     # the first active
    active = torch.arange(P)[None, :] >= start[:, None]
    xs = torch.where(active[..., None], xs, torch.zeros_like(xs))
    cot = torch.randn((B, 3), generator=g)
    o, o1, pull = base.seq_forward_vjp(params, algo.spec, xs, active)
    grads = train_bptt.program_leaves(pull(cot))
    w64 = {k: v.double().requires_grad_(True) for k, v in w.items()}
    r, r1 = lstm.window(w64, arch, xs.double(), active)
    torch.testing.assert_close(o.double(), r, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(o1.double(), r1, rtol=1e-5, atol=1e-6)
    gr = torch.autograd.grad((r * cot.double()).sum(), list(w64.values()))
    assert set(grads) == set(w64)
    for name, b in zip(w64, gr):
        torch.testing.assert_close(grads[name].double(), b, rtol=1e-4,
                                   atol=1e-6, msg=name)


def _episodes(n=6, seed=5, push=0.0):
    """n episodes of the program's no-velocity cart-pole under random
    actions, in the stored layout, and one step of full lane states.
    push: added to the next cart position, if not the dynamics'."""
    from smarties_tpu_torch.envs import cartpole
    env = cartpole.pomdp
    g = torch.Generator().manual_seed(seed)
    s = env.init(g, n)
    L1 = 501
    states = np.zeros((n, L1, 3))
    rewards = np.zeros((n, L1))
    length = np.zeros(n, np.int64)
    terminal = np.zeros(n, bool)
    alive = np.ones(n, bool)
    obs = env.MDP.observed(env.observe(s)).numpy()
    states[:, 0] = obs
    lanes = None
    for t in range(500):
        a = torch.randn((n, 1), generator=g) * 0.5
        s1, r, d, term = env.step(s, 10.0 * torch.tanh(a))
        if push:
            s1 = s1._replace(u=s1.u + torch.tensor([push, 0, 0, 0]))
        if t == 0:
            lanes = {"u0": s.u.double().numpy(), "u1": s1.u.double().numpy(),
                     "action": a.double().numpy(), "served": obs}
        s = s1
        for e in np.nonzero(alive)[0]:
            states[e, t + 1] = env.MDP.observed(env.observe(s)).numpy()[e]
            rewards[e, t + 1] = float(r[e])
            if bool(d[e]):
                alive[e], length[e], terminal[e] = False, t + 1, bool(term[e])
        if not alive.any():
            break
    return {"states": states, "rewards": rewards, "length": length,
            "terminal": terminal}, lanes


def test_the_env_checks_without_the_velocities():
    """The program's env passes with no wrong event and a state gap of
    float32's rounding; a wrong reward shows in the events, a pushed
    cart in the lanes' state gap."""
    cols, lanes = _episodes()
    assert ref.env_gaps(cols) == (0.0, 0)
    assert ref.lane_gaps(lanes) < 1e-6
    bad = {**cols, "rewards": cols["rewards"].copy()}
    bad["rewards"][2, 1] += 0.25
    assert ref.env_gaps(bad)[1] == 1
    _, pushed = _episodes(push=1e-3)
    assert ref.lane_gaps(pushed) > 9e-4


def test_the_cell_is_correct_at_a_tiny_size():
    line = harness.run_cell(CELL, 2147483659, 0.0, False,
                            _tiny.options(CELL))
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"stats", "env_state", "env_events",
                                   "retrace", "loss", "grad", "change",
                                   "rho", "mu"}
    assert line["metrics"]["grad_steps_per_s"]["value"] > 0
    line = harness.run_cell(CELL, 7, 0.0, True, _tiny.options(CELL))
    assert line["correct"], line["checks"]
    m = line["metrics"]
    assert m["train.step_bptt_ms"]["value"] > 0
    assert m["train.bptt_cell_us"]["value"] == pytest.approx(
        m["train.step_bptt_ms"]["value"] * 1e3 / 66)
    assert "train.mfu" not in m                   # no card, no peak


@pytest.mark.parametrize("how", faults_bptt.NAMES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, how):
    faults_bptt.plant(how, monkeypatch.setattr)
    line = harness.run_cell(CELL, 77, 0.0, False, _tiny.options(CELL))
    assert not line["correct"], line["checks"]
    if how == "carry_unreset":
        assert line["checks"]["mu"]["value"] > 0.01


def test_the_readings_at_a_tiny_size():
    out = readings_bptt.readings(CELL, 11, _tiny.options(CELL))
    assert set(out) == {"seed", "program", "tf32", "half_batch"}
    assert out["program"]["mu"] < 1e-4
    assert out["half_batch"]["grad"] > 2e-3


def test_the_recurrent_window_readers():
    step = harness.metric_reader("train.step_bptt_ms")
    cell = harness.metric_reader("train.bptt_cell_us")
    ctx = {"phases": {"phases_ms": {"gather": 0.1, "bptt_forward": 1.5,
                                    "head": 0.01, "bptt_backward": 3.0},
                      "bptt_cells": 66}}
    assert step(ctx) == pytest.approx(4.5)
    assert cell(ctx) == pytest.approx(4500 / 66)
    conv = {"phases": {"phases_ms": {"conv_forward": 0.5, "forward": 0.2,
                                     "backward": 0.1}, "conv_macs": 9}}
    for c in (conv, {}, {"phases": {}}):
        assert step(c) is None and cell(c) is None
    no_count = {"phases": {"phases_ms": ctx["phases"]["phases_ms"]}}
    assert step(no_count) == pytest.approx(4.5) and cell(no_count) is None


def test_a_program_without_a_captured_recurrent_step_stops_at_once(
        monkeypatch):
    """The parent of this cell captures no recurrent step: its run stops
    with the harness's error at the Trainer, before its set-up."""
    from smarties_tpu_torch.algos.vracer import VRacer
    monkeypatch.setattr(VRacer, "captures_bptt", False)
    with pytest.raises(harness.RunError, match="no captured step"):
        harness.run_cell(CELL, 3, 0.0, False, _tiny.options(CELL))

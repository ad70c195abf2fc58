"""The port's bench (smarties_tpu_torch/bench.py), the twin of bench.py.

- The trailing-20 fold: the port's vectorised fold against a jnp
  transcription of bench.py's QualityDispatch.fold (bench.py:202-216),
  over seeded sweeps of 1024 lanes with 0, 1, 19, 21, 128 and 300
  completions, from a ring that has wrapped: ring, count and overflow
  equal (the fold only moves returns, so exactly).
- The whole bench on the CPU at a tiny size (16 envs, 64 slots, 2 fused
  cycles, 2 sweeps and 4 steps in the steady phase, the Atari step on 8
  slots with 2 steps, quality at 2 cycles with 4 blind sweeps and an
  eval of 4 x 50): the line parses, holds bench.py's keys (those of
  BENCH_r05.json's line, the TPU capture's apart) and fits 1800
  characters; the capture lands under build/ and the repo's
  BENCH_partial.json is unchanged. The budget's skips, the wall cut of a
  seed, the partial line on termination, the line's shedding and the
  refusal without a card.
- step_flops at the Atari shapes against XLA's cost analysis of the JAX
  package's one train_step built as bench.py:358-384 and :412-418 build
  it (the replay abstract, so its 466 MB are not allocated): within 5%.
"""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from smarties_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = bench.Sizes(n_envs=16, n_slots=64, fused_cycles=2, steady_sweeps=2,
                   steady_steps=4, atari_slots=8, atari_steps=2,
                   quality_sweeps=4, eval_episodes=4, eval_steps=50)
# keys of bench.py's line that belong to its TPU capture, and its MFU,
# which the port takes against the FP32 peak
TPU_ONLY = {"packed_replay", "capture", "transfer_canary_s",
            "dispatch_drain_s", "atari_mfu_vs_bf16_peak"}


def _jax_fold(trk, done, ret, topk=bench.TOPK, trail=bench.TRAIL):
    """bench.py:202-216, as it is there."""
    order = jnp.argsort(~done)
    d, r = done[order][:topk], ret[order][:topk]
    ovf = jnp.maximum(done.sum() - topk, 0)

    def push(t, dr):
        ring, cnt = t
        dd, rr = dr
        ring2 = jnp.where(dd, ring.at[cnt % trail].set(rr), ring)
        return (ring2, cnt + dd.astype(jnp.int32)), None

    return lax.scan(push, trk, (d, r))[0], ovf


def _sweep(rng, n_done, V=1024):
    done = np.zeros(V, bool)
    done[rng.choice(V, n_done, replace=False)] = True
    return done, (rng.randn(V) * 100).astype(np.float32)


@pytest.mark.parametrize("n_done", [0, 1, 19, 21, 128, 300])
def test_fold_matches_bench_py(n_done):
    rng = np.random.RandomState(n_done)
    jt = (jnp.zeros(bench.TRAIL), jnp.zeros((), jnp.int32))
    ring = torch.zeros(bench.TRAIL)
    count = torch.zeros((), dtype=torch.int64)
    # a few sweeps first, so the ring has wrapped to some offset
    for k in (7, 13, n_done, 3, n_done):
        done, ret = _sweep(rng, k)
        jt, jovf = _jax_fold(jt, jnp.asarray(done), jnp.asarray(ret))
        ring, count, ovf = bench.fold(ring, count, torch.as_tensor(done),
                                      torch.as_tensor(ret))
        np.testing.assert_array_equal(ring.numpy(), np.asarray(jt[0]))
        assert int(count) == int(jt[1])
        assert int(ovf) == int(jovf) == max(k - bench.TOPK, 0)


def test_fold_on_fewer_lanes_than_topk():
    """The tiny bench's 16 lanes: every completion is pushed."""
    rng = np.random.RandomState(5)
    jt = (jnp.zeros(bench.TRAIL), jnp.zeros((), jnp.int32))
    ring, count = torch.zeros(bench.TRAIL), torch.zeros((), dtype=torch.int64)
    for k in (16, 0, 9, 16, 5):
        done, ret = _sweep(rng, k, V=16)
        jt, jovf = _jax_fold(jt, jnp.asarray(done), jnp.asarray(ret))
        ring, count, ovf = bench.fold(ring, count, torch.as_tensor(done),
                                      torch.as_tensor(ret))
        np.testing.assert_array_equal(ring.numpy(), np.asarray(jt[0]))
        assert int(count) == int(jt[1]) and int(ovf) == int(jovf) == 0


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_whole_bench_on_cpu():
    reference = os.path.join(REPO, "BENCH_partial.json")
    before = _sha(reference)
    line, errors = bench.run(TINY, seeds=(0,), quality_cycles=2,
                             device="cpu")
    assert errors == []
    assert len(line) <= bench.LINE_BUDGET
    doc = json.loads(line)
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        jax_line = json.load(f)["parsed"]
    assert set(doc) == set(jax_line)
    assert doc["vs_baseline"] is None
    want = (set(jax_line["extras"]) - TPU_ONLY) | {"atari_mfu_vs_f32_peak"}
    ex = doc["extras"]
    assert want <= set(ex), sorted(want - set(ex))
    assert doc["value"] == ex["combined_env_steps_per_s"] > 0
    for k in ("fused_cycle_ms_min", "fused_cycle_ms_median",
              "fused_cycle_ms_max", "setup_s", "k1_launches",
              "skipped_for_budget", "cut_by_wall_s", "quality_grad_steps"):
        assert k in ex, k
    assert (ex["fused_cycle_ms_min"] <= ex["fused_cycle_ms_median"]
            <= ex["fused_cycle_ms_max"])
    assert ex["atari_flops_per_step_g"] == 12.683
    # no FP32 peak or HBM rate for the CPU: null, with the reason
    assert ex["atari_mfu_vs_f32_peak"] is None
    assert "cpu" in ex["atari_peak_note"]
    assert ex["device"] == "cpu" and ex["skipped_for_budget"] == []
    # no kernel on the CPU: the plain versions ran, no launch counted
    assert ex["k1_launches"] == {"fused": 0, "steady": 0, "atari": 0,
                                 "quality0": 0}
    assert ex["quality_grad_steps"] == [2 * TINY.n_envs]
    assert ex["cut_by_wall_s"] == [False]
    assert np.isfinite(ex["eval_mean_deterministic"][0])
    with open(bench.PARTIAL_PATH) as f:
        partial = json.load(f)
    assert os.path.dirname(bench.PARTIAL_PATH) == os.path.join(REPO, "build")
    assert partial["stage"] == "done"
    q, = partial["quality_detail"]
    assert {"episodes_to_threshold", "episodes_total", "grad_steps",
            "env_steps", "final_trail_mean", "noisy_return_ceiling",
            "tracker_overflow_episodes", "curve_every_cycle",
            "eval_mean_deterministic"} <= set(q)
    assert q["grad_steps"] == q["env_steps"] == 2 * TINY.n_envs
    assert _sha(reference) == before


def test_budget_skips_steady_and_atari(tmp_path):
    line, errors = bench.run(TINY, seeds=(), budget_s=0.0, device="cpu",
                             partial_path=str(tmp_path / "p.json"))
    ex = json.loads(line)["extras"]
    assert errors == [] and ex["skipped_for_budget"] == ["steady", "atari"]
    assert "rollout_env_steps_per_s" not in ex
    assert "atari_train_step_ms" not in ex
    assert ex["fused_cycles"] == TINY.fused_cycles


@pytest.mark.parametrize("wall_s", [0.0, 1e9])
def test_quality_wall_cut_is_reported(wall_s):
    q = bench.quality_seed(1, TINY, 2, "cpu", wall_s=wall_s)
    cut = wall_s == 0.0
    assert q["cut_by_wall_s"] is cut
    assert q["cycles"] == (0 if cut else 2)
    assert q["grad_steps"] == q["cycles"] * TINY.n_envs
    assert np.isfinite(q["eval_mean_deterministic"])


def test_termination_prints_the_partial_line(tmp_path):
    """SIGTERM raises in the main thread; what ran so far is printed."""
    def hook(tr, phase):
        if phase == "quality0":
            raise bench._Terminated()

    line, errors = bench.run(TINY, seeds=(0,), quality_cycles=2,
                             device="cpu", hook=hook,
                             partial_path=str(tmp_path / "p.json"))
    ex = json.loads(line)["extras"]
    assert errors == ["terminated before completion (partial capture)"]
    assert ex["fused_cycles"] == TINY.fused_cycles
    assert "atari_train_step_ms" in ex and "quality_seeds" not in ex


def test_line_sheds_in_bench_py_order():
    extras = {"fused_cycle_ms": 1.0, "wall_s": 2.0, "timing": "t" * 300,
              "device": "d" * 900, "errors": ["e" * 900],
              "final_trail_mean": [1.0] * 5}
    line = bench._fit_line({"metric": "m", "value": 0.0, "unit": "u",
                            "vs_baseline": None, "extras": dict(extras)})
    got = json.loads(line)["extras"]
    assert len(line) <= bench.LINE_BUDGET
    # timing, then final_trail_mean and device went; errors stayed
    assert set(got) == {"fused_cycle_ms", "wall_s", "errors"}
    huge = dict(extras, errors=["e" * 3000])
    line = bench._fit_line({"metric": "m", "value": 0.0, "unit": "u",
                            "vs_baseline": None, "extras": huge})
    assert json.loads(line)["extras"] == {"fused_cycle_ms": 1.0,
                                          "wall_s": 2.0}


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--seeds"])


def test_step_flops_against_xla_cost_analysis():
    from smarties_tpu.algos.vracer import VRacer as JVRacer
    from smarties_tpu.core.mdp import MDPSpec as JMDP
    from smarties_tpu.replay import buffer as jrb
    from smarties_tpu.utils.config import HyperParameters as JHP
    from smarties_tpu_torch.runtime.profile_main import (atari_setup,
                                                         step_flops)
    mdp = JMDP(dim_state=84 * 84, dim_action=1, discrete_values=(6,),
               n_appended_obs=3,
               conv_layers=((84, 84, 4, 32, 8, 4), (20, 20, 32, 64, 4, 2),
                            (9, 9, 64, 64, 3, 1)))
    cfg = JHP(batchSize=128, nnLayerSizes=[512], gamma=0.99,
              minTotObsNum=16384, maxTotObsNum=262144)
    algo = JVRacer(mdp, cfg)
    params, opt = algo.init(jax.random.PRNGKey(0))
    rs = jax.eval_shape(lambda: jrb.init_replay(
        512, 128, mdp.dim_state_observed, mdp.dim_action, mdp.dim_policy,
        cfg.clipImpWeight, state_dtype=jnp.uint8, mu_init=jrb.safe_mu(mdp)))
    cost = jax.jit(algo.train_step).lower(
        params, opt, rs, jax.random.PRNGKey(2)).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    xla = float(cost["flops"])
    t_algo, *_ = atari_setup("cpu", n_slots=2, max_len=4)
    B = t_algo.cfg.batchSize
    ours = step_flops(t_algo.spec, 2 * B, 2 * B)
    assert round(ours / 1e9, 3) == 12.683     # profile_main's count
    assert abs(ours - xla) / xla < 0.05, (ours, xla)

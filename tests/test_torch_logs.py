"""The trainer's logs in the port: the raw observation stream, the
gradient-moment dump, the stats table, the importance-weight histogram
and the phase profiler (smarties_tpu_torch/runtime/trainer.py,
replay/collector.py record_obs, utils/stats.py, utils/profiler.py
against the JAX package's).

- `_write_obs_rows` fed the same record arrays as the JAX Trainer's
  writes byte-equal output.
- `replay_metrics`, `stats_row` and `iw_histogram` on a replay converted
  from a JAX one (warmup, then train steps, so rho, kl and delta are
  not trivial): the metrics within rtol 1e-5 / atol 1e-6 (f32 sums in
  another order), the printed row and histogram equal as text (the
  histogram's counts are exact: the port bins in f64 as numpy does).
- A deterministic rollout with record_obs logs the same rows as the JAX
  collector (rtol 1e-4 / atol 1e-5, the states of test_torch_slice.py).
- The twin of tests/test_e2e_cartpole.py::test_obs_log_stream, the
  grads_rank00.raw rows against the metrics they come from, the
  profiler's table, --logAllSamples through the launcher, and the JAX
  package's numpy-only viewers (bin/smarties_tpu_plot_{rew,obs,grads}.py)
  reading a port run directory.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import torch

from smarties_tpu.envs import cartpole as jc
from smarties_tpu.runtime.trainer import Trainer as JTrainer
from smarties_tpu.utils import stats as jstats
from smarties_tpu.utils.config import HyperParameters as JHP
from smarties_tpu_torch import launch
from smarties_tpu_torch.envs import cartpole as tc
from smarties_tpu_torch.models import convert
from smarties_tpu_torch.runtime.trainer import Trainer as TTrainer
from smarties_tpu_torch.utils import stats as tstats
from smarties_tpu_torch.utils.config import HyperParameters as THP
from smarties_tpu_torch.utils.profiler import Profiler

from _torch_parity import jax_replay_views, tn, tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(minTotObsNum=256, maxTotObsNum=1024, batchSize=32,
           obsPerStep=1.0, nnLayerSizes=[16])


def test_write_obs_rows_byte_equal(tmp_path):
    rng = np.random.RandomState(0)
    k, V, d = 5, 8, tc.MDP.dim_state_observed
    status_f = np.where(rng.rand(k, V) < 0.3, rng.choice([2.0, 3.0], (k, V)),
                        0.0).astype(np.float32)
    rec = (rng.randn(k, V, d).astype(np.float32),
           rng.randn(k, V).astype(np.float32),
           (rng.rand(k, V) > 0.2).astype(np.float32),
           rng.randn(k, V, d).astype(np.float32),
           rng.randn(k, V).astype(np.float32), status_f)
    jt = JTrainer(jc, jc.MDP, JHP(**CFG), n_envs=V, n_slots=32, max_len=32,
                  run_dir=str(tmp_path / "jax"), obs_log=True)
    pt = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=V, n_slots=32, max_len=32,
                  run_dir=str(tmp_path / "port"), obs_log=True,
                  device="cpu")
    jt._write_obs_rows(rec)
    pt._write_obs_rows(tuple(tt(x) for x in rec))
    jt._obs_file.flush()
    pt._obs_file.flush()
    want = (tmp_path / "jax" / "agent_00_rank00_obs.raw").read_bytes()
    got = (tmp_path / "port" / "agent_00_rank00_obs.raw").read_bytes()
    assert len(want) == 4 * (k * V + int((status_f > 0).sum())) * (d + 3)
    assert got == want


def _jax_trained_replay():
    jt = JTrainer(jc, jc.MDP, JHP(**dict(CFG, nnLayerSizes=[16, 16])),
                  n_envs=16, n_slots=64, max_len=64)
    jt.warmup(chunk=16)
    jt.train(100, log_every=10 ** 9)
    return jax.device_get(jt.replay), jt.n_grad_steps


def test_stats_on_a_converted_replay():
    jr, g = _jax_trained_replay()
    tr = convert.replay_from_jax(jax_replay_views(jr))
    want, got = jstats.replay_metrics(jr), tstats.replay_metrics(tr)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert want["nFarP"] >= 0 and want["DKL"] > 0 and want["RMSE"] > 0
    assert tstats.stats_header() == jstats.stats_header()
    assert tstats.stats_row(tr, g) == jstats.stats_row(jr, g)
    assert tstats.iw_histogram(tr) == jstats.iw_histogram(jr)
    assert tstats.iw_histogram(tr, n_bins=11) \
        == jstats.iw_histogram(jr, n_bins=11)
    # the metrics come from one device tensor
    dev = tstats.replay_metrics_device(tr)
    assert dev.shape == (len(tstats.METRIC_KEYS),)
    # an empty replay
    from smarties_tpu_torch.replay import buffer as rb
    empty = rb.init_replay(8, 16, 6, 1, 2, 4.0, device="cpu")
    assert tstats.iw_histogram(empty) == "(empty replay)"


def test_record_obs_rows_match_the_jax_collector(tmp_path):
    """Deterministic acting from the same params and starts until the
    first lane finishes: the obs stream's rows of both trainers."""
    cfg = dict(CFG, bTrain=False, nnLayerSizes=[16, 16])
    jt = JTrainer(jc, jc.MDP, JHP(**cfg), n_envs=16, n_slots=64, max_len=64,
                  run_dir=str(tmp_path / "jax"), obs_log=True)
    pt = TTrainer(tc, tc.MDP, THP(**cfg), n_envs=16, n_slots=64, max_len=64,
                  run_dir=str(tmp_path / "port"), obs_log=True,
                  device="cpu")
    params = convert.params_from_jax(jax.device_get(jt.params))
    pt.carry = pt.carry._replace(env_state=tc.init(
        None, 16, u_new=tt(np.asarray(jt.carry.env_state.u))))
    jc_, pc_ = jt.carry, pt.carry
    for sweep in range(64):
        jc_, jlogs = jt._rollout(jt.params, jc_, 1)
        pc_, plogs = pt._rollout(params, pc_, 1)
        assert len(plogs) == len(jlogs) == 9
        jt._write_obs_rows(jlogs[3:])
        pt._write_obs_rows(plogs[3:])
        if np.asarray(jlogs[0]).any():
            break
    assert 0 < sweep < 63
    jt._obs_file.flush()
    pt._obs_file.flush()
    d = tc.MDP.dim_state_observed + 3
    want = np.fromfile(tmp_path / "jax" / "agent_00_rank00_obs.raw",
                       np.float32).reshape(-1, d)
    got = np.fromfile(tmp_path / "port" / "agent_00_rank00_obs.raw",
                      np.float32).reshape(-1, d)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_obs_log_stream_and_grads(tmp_path):
    """tests/test_e2e_cartpole.py::test_obs_log_stream: f32 rows [lane,
    status, state..., reward], INIT at episode starts and TERM / LAST
    rows at episode ends; the grads dump's rows are the last step's
    metrics."""
    run_dir = str(tmp_path / "run")
    tr = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=8, n_slots=64, max_len=64,
                  run_dir=run_dir, obs_log=True, device="cpu")
    tr.warmup(chunk=16)
    tr.train(30, log_every=10 ** 9)
    tr._flush_logs()
    tr._obs_file.flush()
    dim_s = tc.MDP.dim_state_observed
    rows = np.fromfile(f"{run_dir}/agent_00_rank00_obs.raw", np.float32)
    assert rows.size % (dim_s + 3) == 0 and rows.size > 0
    rows = rows.reshape(-1, dim_s + 3)
    status = rows[:, 1].astype(int)
    assert (status == 0).sum() >= 8          # INITs (>= one per lane)
    assert ((status == 2) | (status == 3)).sum() > 0  # episode ends
    n_done = int(((status == 2) | (status == 3)).sum())
    # one row per served step + one per episode end
    assert len(rows) == (status < 2).sum() + n_done
    assert np.isfinite(rows).all()
    # the served rows count every lane's every env step
    assert (status < 2).sum() == tr.n_env_steps
    tr.log_status()
    g = np.fromfile(f"{run_dir}/grads_rank00.raw", np.float32)
    assert g.size % 3 == 0 and g.size > 0 and np.isfinite(g).all()
    m = tr._last_metrics
    np.testing.assert_allclose(
        g.reshape(-1, 3)[-1], [tr.n_grad_steps, float(m["grad_norm"][-1]),
                               float(m["grad_max"][-1])], rtol=1e-6)
    # without obs_log, or without a run directory, no obs stream
    plain = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=8, n_slots=64,
                     max_len=64, run_dir=str(tmp_path / "plain"),
                     device="cpu")
    assert plain._obs_file is None and plain._grads_file is not None
    assert not TTrainer(tc, tc.MDP, THP(**CFG), n_envs=8, n_slots=64,
                        max_len=64, obs_log=True, device="cpu").obs_log


def test_log_status_full_and_profiler(capsys):
    tr = TTrainer(tc, tc.MDP, THP(**CFG), n_envs=8, n_slots=64, max_len=64,
                  device="cpu")
    tr.warmup(chunk=16)
    tr.train(1000, log_every=10 ** 9)
    tr.train_fused(16, log_every=10 ** 9)
    capsys.readouterr()
    tr.log_status(full=True)
    out = capsys.readouterr().out.splitlines()
    assert out[1] == tstats.stats_header()
    assert out[2] == tstats.stats_row(tr.replay, tr.n_grad_steps)
    assert out[3].startswith("OFF-POLICY IMP WEIGHTS HISTOGRAM")
    assert out[5] == "profiler:"
    keys = {line.split(":")[0].strip() for line in out[6:]}
    assert keys == {"ROLL", "TRAIN", "REFRESH", "HOST"}
    p = tr.profiler
    assert p.counts["REFRESH"] == 1 and p.counts["TRAIN"] >= 11
    assert all(v >= 0 for v in p.totals.values())


def test_profiler_on_the_cpu():
    p = Profiler("cpu")
    assert not p.cuda
    with p("A"):
        sum(range(10000))
    p.start("B")
    p.stop("B")
    p.stop("never started")
    table = p.table().splitlines()
    assert [line.split(":")[0].strip() for line in table] == ["A", "B"]
    assert p.counts == {"A": 1, "B": 1}
    assert "100.0%" not in table[1]
    p.reset()
    assert p.table() == ""


def test_log_all_samples_and_the_plot_scripts(tmp_path):
    """--logAllSamples through the launcher writes the obs stream; the
    JAX package's viewers read the port's run directory."""
    args = launch.parse_args([
        "cartpole", "--recipe", '{"nnLayerSizes": [16], "batchSize": 16, '
        '"minTotObsNum": 256, "maxTotObsNum": 1024}', "--device", "cpu",
        "--runprefix", str(tmp_path), "--runname", "r0", "--nEnvironments",
        "8", "--nTrainSteps", "30", "--maxEpisodeLength", "64",
        "--logAllSamples", "--noCheckpoint"])
    assert args.logAllSamples
    tr = launch.run(args)
    tr.log_status()
    for f in (tr._obs_file, tr._rew_file):
        f.flush()
    run = tmp_path / "r0"
    d = tc.MDP.dim_state_observed
    rows = np.fromfile(run / "agent_00_rank00_obs.raw", np.float32)
    assert rows.size > 0 and rows.size % (d + 3) == 0

    def viewer(name, *argv):
        return subprocess.run(
            [sys.executable, os.path.join(REPO, "bin", name), *argv],
            capture_output=True, text=True, timeout=60, check=True).stdout

    out = viewer("smarties_tpu_plot_obs.py", str(run / "agent_00_rank00_"
                                                "obs.raw"),
                 "--dim-state", str(d))
    assert out.startswith(f"{rows.size // (d + 3)} records, {d} state dims")
    assert "INIT:" in out and "TERM:" in out
    out = viewer("smarties_tpu_plot_rew.py", str(run))
    assert "final (window" in out
    out = viewer("smarties_tpu_plot_grads.py", str(run / "grads_rank00.raw"))
    lines = out.splitlines()
    assert lines[0].split() == ["step", "grad_norm", "grad_max"]
    assert int(lines[-1].split()[0]) == tr.n_grad_steps

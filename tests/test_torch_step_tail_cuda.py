"""The step-tail kernel on the card (csrc/step_tail.cu via
ops/step_tail_kernel.py) against the chain it replaces
(algos/base.py::step_tail_plain_), run on the same card.

Marked `cuda`: skipped where torch sees no CUDA card. This file imports
neither jax nor the JAX package; run it on a machine without them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_step_tail_cuda.py

- Seven learner paths (V-RACER and RACER on cart-pole, RACER-discrete
  over catch.small's conv net, DQN, NAF, DPG, MixedPG), 200 captured grad
  steps each with the kernel and with the chain from one state: every
  replay field and ReF-ER scalar, the params and the optimiser state
  torch.equal; the step metrics within 1e-6 of the chain's, relative
  (avg_v, whose terms take either sign, relative to the terms'
  magnitude), frac_far_data, beta and grad_max exact; one step_tail and
  one grad_stats launch a step, over graph replays.
- Rows that are invalid (they write nothing, in the kernel as in the
  chain) and rows that repeat an (ep, t) (one of their values is
  stored; each adds its far-count delta).
- A tail captured in a graph, replayed; under a mesh of one and of two
  gloo ranks the kernel (three launches and the chain's three
  collectives) against the chain under the same mesh; the wrapper's
  refusals.
"""
import datetime
import os

import pytest
import torch

import _torch_tail_cases as cases
from smarties_tpu_torch import launch
from smarties_tpu_torch.algos import base
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import step_tail_kernel as stk
from smarties_tpu_torch.runtime import graphs
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters

N_ENVS, N_SLOTS, MAX_LEN, STEPS = 16, 64, 64, 200
CFG = dict(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
           nnLayerSizes=[16, 16], obsPerStep=1.0, randSeed=0)
# path -> (app, settings)
PATHS = {
    "vracer": ("cartpole", {}),
    "racer": ("cartpole", dict(learner="RACER")),
    "racer_discrete_conv": ("catch.small", dict(learner="RACER")),
    "dqn": ("cartpole_discrete", dict(learner="DQN", targetDelay=2)),
    "naf": ("pendulum", dict(learner="NAF", clipImpWeight=0.0,
                             targetDelay=0.01)),
    "dpg": ("pendulum", dict(learner="DPG", clipImpWeight=0.0,
                             encoderLayerSizes=[16], targetDelay=0.01)),
    "mixedpg": ("cartpole", dict(learner="MixedPG")),
}
EXACT = ("frac_far_data", "beta", "grad_max")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _trainer(path, dev):
    app, kw = PATHS[path]
    if app == "catch.small":
        from smarties_tpu_torch.envs import catch
        env, extra = catch.small, dict(state_dtype=torch.uint8)
        kw = dict(kw, minTotObsNum=64, maxTotObsNum=448)
    else:
        env, extra = launch.env_module(app), {}
    tr = Trainer(env, env.MDP, HyperParameters(**dict(CFG, **kw)),
                 n_envs=N_ENVS, n_slots=N_SLOTS,
                 max_len=min(MAX_LEN, env.MAX_STEPS), device=dev, **extra)
    assert tr.graphs
    return tr


def _chain_tail(rs, mb, cfg, opt_step, grads, rho, dkl, delta, value,
                advantage, v_next, is_far, net2v=False, mesh=None):
    return base.step_tail_plain_(rs, mb, cfg, opt_step, grads, rho, dkl,
                                 delta, value, advantage, v_next, is_far,
                                 mesh, net2v)


def _tensors(x, name=""):
    import dataclasses
    if isinstance(x, torch.Tensor):
        return [(name, x)]
    if isinstance(x, dict):
        return [p for k in sorted(x) for p in _tensors(x[k], f"{name}.{k}")]
    if isinstance(x, (list, tuple)):
        keys = getattr(x, "_fields", range(len(x)))
        return [p for k, v in zip(keys, x) for p in _tensors(v, f"{name}.{k}")]
    if dataclasses.is_dataclass(x):
        return [p for f in dataclasses.fields(x)
                for p in _tensors(getattr(x, f.name), f"{name}.{f.name}")]
    return []


def _assert_metrics_close(got, want, v_scale):
    """got, want: metric -> tensor (any shape), equal where EXACT, else
    within 1e-6 of want's magnitude; avg_v's terms take either sign, so
    its tolerance is 1e-6 of `v_scale`, the terms' magnitude, if that is
    larger."""
    assert list(got) == list(want)
    for k in got:
        if k in EXACT:
            assert torch.equal(got[k], want[k]), k
        else:
            mag = torch.abs(want[k])
            if k == "avg_v":
                mag = torch.clamp(mag, min=v_scale)
            assert torch.all(torch.abs(got[k] - want[k]) <= 1e-6 * mag), \
                (k, (got[k] - want[k]).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(PATHS))
def test_captured_steps_equal_the_chain(cuda, path, monkeypatch):
    """200 captured steps with the kernel and with the chain, from one
    state: the replay, its scalars, the params and the optimiser state
    torch.equal; the metrics of every step close (exact where EXACT);
    one launch of each kernel a step, counted over graph replays."""
    if path == "racer_discrete_conv":
        # cuDNN's default conv backward sums with atomics: two runs of
        # one program differ in the last bits without this
        monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = {}
    for mode in ("kernel", "chain"):
        with monkeypatch.context() as m:
            if mode == "chain":
                m.setattr(stk, "tail_", _chain_tail)
            tr = _trainer(path, cuda)
            tr.warmup(chunk=16)
            cuda_lib.reset_launches()
            metrics = tr._train_chunk(STEPS)
            torch.cuda.synchronize()
            runs[mode] = (tr, {k: v.clone() for k, v in metrics.items()},
                          dict(stk.launches))
    (kt, km, kl), (ct, cm, cl) = runs["kernel"], runs["chain"]
    assert kl == {"step_tail": STEPS, "grad_stats": STEPS, "finish": 0}, kl
    assert cl == {"step_tail": 0, "grad_stats": 0, "finish": 0}, cl
    assert all(g.graph is not None for g in kt._step_graphs.values())
    sk = _tensors({"params": kt.params, "opt": kt.opt_state,
                   "replay": kt.replay})
    sc = _tensors({"params": ct.params, "opt": ct.opt_state,
                   "replay": ct.replay})
    assert [k for k, _ in sk] == [k for k, _ in sc]
    for (k, x), (_, y) in zip(sk, sc):
        assert torch.equal(x, y), f"{path}: {k}"
    # avg_v's terms are at most the largest value the steps wrote
    _assert_metrics_close(km, cm, float(kt.replay.value_tm.abs().max()))


def _tail_both(dev, **kw):
    """One tail through the kernel and through the chain from one case
    -> ((rs, metrics) kernel, (rs, metrics) chain, mb, rows)."""
    c = cases.cfg()
    rs, mb, r, grads, step = cases.case(dev, **kw)
    ref = cases.clone_replay(rs)
    cuda_lib.reset_launches()
    got = base.step_tail_(rs, mb, c, step, grads, **r)
    torch.cuda.synchronize()
    assert stk.launches == {"step_tail": 1, "grad_stats": 1, "finish": 0}
    want = base.step_tail_plain_(ref, mb, c, step, grads, **r)
    return got, want, mb, r


@pytest.mark.cuda
@pytest.mark.parametrize("ep_dtype", [torch.int32, torch.int64])
def test_kernel_equals_chain_on_distinct_rows(cuda, ep_dtype):
    (rk_, mk), (rc, mc), _, r = _tail_both(cuda, seed=11, ep_dtype=ep_dtype,
                                           invalid=3)
    for f in cases.TAIL_FIELDS:
        assert torch.equal(getattr(rk_, f), getattr(rc, f)), f
    _assert_metrics_close(mk, mc, float(r["value"].abs().mean()))


@pytest.mark.cuda
def test_invalid_and_repeated_rows(cuda):
    """Row 31 repeats row 0's (ep, t) and is invalid: row 0's values are
    stored, by the kernel and by the chain. Rows 4 and 5 repeat row 3's
    (ep, t) with values of their own: one of the three rows' values is
    stored, field by field. Rows 29 and 30 sample empty slots and write
    nothing. Each row adds its own far-count delta, so far_count equals
    the chain's. Every place but row 3's equals the chain's."""
    (rk_, mk), (rc, mc), mb, r = _tail_both(cuda, seed=12, invalid=3,
                                            shared=1, dup=2)
    ep, t = mb.ep.long().tolist(), mb.t.long().tolist()
    valid, trunc = mb.valid.tolist(), mb.truncated_next.tolist()
    keys = [s * rk_.n_slots + e for e, s in zip(ep, t)]
    rows_at = {}
    for i, k in enumerate(keys):
        rows_at.setdefault(k, []).append(i)
    assert sorted(len(v) for v in rows_at.values())[-2:] == [2, 3]
    assert not valid[31] and keys[31] == keys[0]
    dup = keys[3]
    assert rows_at[dup] == [3, 4, 5] and all(valid[i] for i in (3, 4, 5))
    for field, row in (("rho_tm", "rho"), ("kl_tm", "dkl"),
                       ("delta_tm", "delta"), ("value_tm", "value"),
                       ("advantage_tm", "advantage")):
        a, b = getattr(rk_, field).flatten(), getattr(rc, field).flatten()
        rest = torch.ones_like(a, dtype=torch.bool)
        rest[dup] = False
        assert torch.equal(a[rest], b[rest]), field
        wrote = {float(r[row][i]) for i in rows_at[dup]}
        assert float(a[dup]) in wrote and float(b[dup]) in wrote, field
        assert a[keys[0]] == r[row][0], field
    for f in ("far_count", "cmax_ret", "cinv_ret", "beta", "alpha",
              "max_abs_error"):
        assert torch.equal(getattr(rk_, f), getattr(rc, f)), f
    # v_trunc: a slot that several truncated rows hit holds one of theirs
    for e in range(rk_.n_slots):
        hit = [i for i in range(len(keys)) if trunc[i] and ep[i] == e]
        if len(hit) > 1:
            assert float(rk_.v_trunc[e]) in {float(r["v_next"][i])
                                            for i in hit}, e
        else:
            assert torch.equal(rk_.v_trunc[e], rc.v_trunc[e]), e
    _assert_metrics_close(mk, mc, float(r["value"].abs().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("net2v", [False, True])
def test_captured_tail_replayed(cuda, net2v):
    """The tail of a fixed batch in a runtime/graphs.Graph with Adam's
    step count advancing (2 eager warm-up calls, the capture, 49 more
    replays) equals 52 chain tails; the counters count the replays."""
    c = cases.cfg()
    rs, mb, r, grads, step = cases.case(cuda, seed=13, invalid=2)
    ref = cases.clone_replay(rs)
    ref_step = step.clone()
    out = {}

    def fn(st):
        st["step"].add_(1)
        _, m = base.step_tail_(st["rs"], mb, c, st["step"], grads, **r,
                               net2v=net2v)
        for k, v in m.items():
            st["m"][k].copy_(v)
        return st, None

    state = {"rs": rs, "step": step,
             "m": {k: torch.zeros((), device=cuda) for k in stk.METRICS}}
    graph = graphs.Graph(fn, state, device=cuda)
    cuda_lib.reset_launches()
    n = graphs.WARMUP_CALLS + 50
    for _ in range(n):
        graph()
        ref_step.add_(1)
        _, out = base.step_tail_plain_(ref, mb, c, ref_step, grads, **r,
                                       net2v=net2v)
    torch.cuda.synchronize()
    assert graph.graph is not None
    assert stk.launches == {"step_tail": n, "grad_stats": n, "finish": 0}
    for f in cases.TAIL_FIELDS:
        assert torch.equal(getattr(rs, f), getattr(ref, f)), f
    _assert_metrics_close(state["m"], out, float(r["value"].abs().mean()))


@pytest.mark.cuda
def test_mesh_tail_on_card(cuda, tmp_path):
    """Under a mesh (one gloo rank) a CUDA step takes the kernel: its
    three launches and the chain's three collectives (a psum of the
    counts, a pmax of the largest error, a psum of the means), equal to
    the chain under the same mesh."""
    import torch.distributed as dist

    from smarties_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got, want, counts, launches = cases.mesh_tails(
            cuda, make_mesh(cuda), seed=14)
        assert counts == {"kernel": {"psum": 2, "pmax": 1},
                          "chain": {"psum": 2, "pmax": 1}}, counts
        assert launches == {"step_tail": 1, "grad_stats": 1, "finish": 1}
        _assert_mesh_tails(got, want)
    finally:
        dist.destroy_process_group()


def _assert_mesh_tails(got, want):
    """got, want: (replay fields, metrics) of the kernel and the chain."""
    for f in cases.TAIL_FIELDS:
        assert torch.equal(got[0][f], want[0][f]), f
    _assert_metrics_close(got[1], want[1], float(want[0]["value_tm"].abs()
                                                 .mean()))


@pytest.mark.cuda
def test_mesh_tail_two_ranks_on_card(cuda, tmp_path):
    """Two gloo ranks on one card, each with a replay and rows of its own
    (invalid rows among them): on each rank the kernel under the mesh
    equals the chain under the mesh (replay fields and ReF-ER scalars
    torch.equal, metrics close), with three launches a tail, and the
    ReF-ER scalars and metrics, which are global, agree across ranks."""
    outs = cases.two_ranks(tmp_path, "cuda:0")
    for o in outs:
        assert o["launches"] == {"step_tail": 1, "grad_stats": 1,
                                 "finish": 1}
        _assert_mesh_tails(o["kernel"], o["chain"])


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non_contiguous", "f64", "mixed_device"])
def test_wrapper_raises(cuda, bad):
    rs, mb, r, grads, step = cases.case(cuda, seed=15)
    if bad == "non_contiguous":
        rs.value_tm = rs.value_tm.t().contiguous().t()
    elif bad == "f64":
        rs.rho_tm = rs.rho_tm.double()
    else:
        rs.v_trunc = rs.v_trunc.cpu()
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="step_tail_kernel"):
        base.step_tail_(rs, mb, cases.cfg(), step, grads, **r)
    assert sum(stk.launches.values()) == 0

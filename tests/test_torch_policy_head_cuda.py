"""V-RACER's continuous head on the card (csrc/policy_head.cu via
ops/policy_head_kernel.py) against the chain it replaces
(algos/vracer.py::VRacer.output_grad_plain), run on the same card.

Marked `cuda`: skipped where torch sees no CUDA card. This file imports
neither jax nor the JAX package; run it on a machine without them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_policy_head_cuda.py

- The kernel against the chain on the same inputs (tests/_torch_head_
  cases.py) at nA = 1, 2 and 6, over bounded, unbounded and mixed masks,
  beta at 0, 1 and between, cmax_ret above 1 and at 1 (no filtering):
  g, rho, dkl, delta_q, v_val, a_val and is_far torch.equal at nA = 1,
  within 2 ulp at nA > 1 (where the sums over dims may take another
  order than torch.sum's), is_far equal; one launch a call.
- A head captured in a graph with beta changing at each of its 200
  calls: equal to the chain's at the last, 200 launches over replays.
- 200 captured grad steps of V-RACER on cart-pole and on the pendulum
  with the kernel and with the chain, from one state: the params, the
  optimiser state and the replay torch.equal; one launch a step.
- RACER's Gaussian advantage and RACER-discrete keep the chain on the
  card: no launch. The wrapper's refusals.
"""
import pytest
import torch

import _torch_head_cases as cases
from smarties_tpu_torch import launch
from smarties_tpu_torch.algos.vracer import VRacer
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import policy_head_kernel as phk
from smarties_tpu_torch.runtime import graphs
from smarties_tpu_torch.runtime.trainer import Trainer
from smarties_tpu_torch.utils.config import HyperParameters

STEPS = 200


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_rows(got, want, nA):
    """Every row of the head torch.equal at nA = 1, within 2 ulp at nA >
    1; the far-policy flags equal."""
    for name, x, y in zip(cases.ROWS, got, want):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        if nA == 1 or x.dtype == torch.bool:
            assert torch.equal(x, y), (name, cases.ulps(x, y))
        else:
            assert torch.isfinite(y).all(), name
            assert cases.ulps(x, y) <= 2, (name, cases.ulps(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("nA", [1, 2, 6])
@pytest.mark.parametrize("kind", ["bounded", "unbounded", "mixed"])
@pytest.mark.parametrize("beta, cmax", [(0.37, 4.0), (0.0, 4.0),
                                        (1.0, 4.0), (0.37, 1.0)],
                         ids=["beta_mid", "beta_0", "beta_1", "no_filter"])
def test_kernel_equals_chain(cuda, nA, kind, beta, cmax):
    algo = cases.learner(nA, kind)
    out, mb, rs = cases.case(cuda, algo, seed=10 + nA, beta=beta, cmax=cmax)
    cuda_lib.reset_launches()
    got = algo.output_grad(out, mb, rs)
    assert phk.launches == {"continuous": 1}
    want = algo.output_grad_plain(out, mb, rs)
    torch.cuda.synchronize()
    _assert_rows(got, want, nA)
    rho, is_far = want[1], want[6]
    if cmax > 1.0:
        # far rows on both sides, clipped log-weights on both sides
        assert bool((is_far & (rho > 1)).any()) and \
            bool((is_far & (rho < 1)).any())
        lw = torch.log(rho)
        assert float(lw.max()) > 6.99 and float(lw.min()) < -6.99
    else:
        assert not bool(is_far.any())


@pytest.mark.cuda
def test_captured_head_replayed(cuda):
    """The head in a runtime/graphs.Graph with beta decaying in place at
    each call (2 eager warm-up calls, the capture, 197 more replays)
    equals the chain at the last beta; 200 launches over the replays."""
    algo = cases.learner(1, "bounded")
    out, mb, rs = cases.case(cuda, algo, seed=20)
    ref_beta = rs.beta.clone()
    rows = algo.output_grad_plain(out, mb, rs)
    state = {"beta": rs.beta, "rows": [torch.zeros_like(x) for x in rows]}

    def fn(st):
        st["beta"].mul_(0.995)
        got = algo.output_grad(out, mb, rs)
        for buf, x in zip(st["rows"], got):
            buf.copy_(x)
        return st, None

    graph = graphs.Graph(fn, state, device=cuda)
    cuda_lib.reset_launches()
    for _ in range(STEPS):
        graph()
        ref_beta.mul_(0.995)
    torch.cuda.synchronize()
    assert graph.graph is not None
    assert phk.launches == {"continuous": STEPS}
    assert torch.equal(rs.beta, ref_beta)
    want = algo.output_grad_plain(out, mb, rs)
    _assert_rows(state["rows"], want, 1)


def _trainer(app, dev):
    env = launch.env_module(app)
    cfg = HyperParameters(minTotObsNum=256, maxTotObsNum=2048, batchSize=32,
                          nnLayerSizes=[16, 16], obsPerStep=1.0, randSeed=0)
    tr = Trainer(env, env.MDP, cfg, n_envs=16, n_slots=64,
                 max_len=min(64, env.MAX_STEPS), device=dev)
    assert tr.graphs and isinstance(tr.algo, VRacer)
    return tr


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


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["cartpole", "pendulum"])
def test_captured_steps_equal_the_chain(cuda, app, monkeypatch):
    """200 captured V-RACER grad steps with the kernel and with the chain
    from one state: params, optimiser state and replay torch.equal (the
    parameters after Adam equal the chain's at every step that follows);
    one launch a step, counted over graph replays."""
    runs = {}
    for mode in ("kernel", "chain"):
        with monkeypatch.context() as m:
            if mode == "chain":
                m.setattr(VRacer, "output_grad", VRacer.output_grad_plain)
            tr = _trainer(app, cuda)
            tr.warmup(chunk=16)
            cuda_lib.reset_launches()
            tr._train_chunk(STEPS)
            torch.cuda.synchronize()
            runs[mode] = (tr, dict(phk.launches))
    (kt, kl), (ct, cl) = runs["kernel"], runs["chain"]
    assert kl == {"continuous": STEPS} and cl == {"continuous": 0}, (kl, cl)
    assert all(g.graph is not None for g in kt._step_graphs.values())
    sk = _tensors({"params": kt.params, "opt": kt.opt_state,
                   "replay": kt.replay})
    sc = _tensors({"params": ct.params, "opt": ct.opt_state,
                   "replay": ct.replay})
    assert [k for k, _ in sk] == [k for k, _ in sc]
    for (k, x), (_, y) in zip(sk, sc):
        assert torch.equal(x, y), f"{app}: {k}"


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["gaussian", "discrete"])
def test_other_heads_keep_the_chain_on_card(cuda, family):
    algo = cases.learner(2, "mixed", family)
    out, mb, rs = cases.case(cuda, algo, seed=30)
    cuda_lib.reset_launches()
    got = algo.output_grad(out, mb, rs)
    want = algo.output_grad_plain(out, mb, rs)
    assert phk.launches == {"continuous": 0}
    for name, x, y in zip(cases.ROWS, got, want):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["f64_out", "non_contiguous_action",
                                 "cpu_mu", "short_qret", "f32_valid"])
def test_wrapper_raises(cuda, bad):
    algo = cases.learner(2, "mixed")
    out, mb, rs = cases.case(cuda, algo, seed=31)
    if bad == "f64_out":
        out = out.double()
    elif bad == "non_contiguous_action":
        mb.action = mb.action.t().contiguous().t()
    elif bad == "cpu_mu":
        mb.mu = mb.mu.cpu()
    elif bad == "short_qret":
        mb.qret = mb.qret[:-1]
    else:
        mb.valid = mb.valid.float()
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="policy_head_kernel"):
        algo.output_grad(out, mb, rs)
    assert phk.launches == {"continuous": 0}

"""The LSTM's BPTT window on the card (csrc/lstm_window.cu via
ops/lstm_window_kernel.py) against its plain version on the same card
and against the float64 chain it replaces (algos/base.py::seq_outputs on
the CPU).

Marked `cuda`: skipped where torch sees no CUDA card. This file imports
neither jax nor the JAX package; run it on a machine without them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_lstm_window_cuda.py

- base.window_outputs on the card (the kernel, then the output layer)
  against the plain version in float32 on the card and the float64 chain
  on the CPU: the outputs at t and t+1, the top layer's h at both and
  every leaf's gradient, at the benchmark cell's shapes (LSTM [32, 32]
  over 3 inputs, batch 128, W = 16) and at [16, 24] over 5 and [8] over
  2 with W = 1, 4 and 16, on windows whose rows cover inactive prefixes,
  an inactive t and holes;
- two calls bit-equal, a captured replay torch.equal to an eager call,
  and one forward, one backward and one reduce launch a call, counted
  over replays; the no-grad forward: one launch, nothing saved, the same
  outputs;
- the dispatch on the card: an LSTM that `takes` admits launches, GRU,
  RNN and LSTM [128] keep the chain; the refusals the card adds
  (float64, two devices).
"""
import pytest
import torch

import _torch_lstm_window_cases as cases
from smarties_tpu_torch.algos import base
from smarties_tpu_torch.models import net as tnet
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import lstm_window_kernel as lw
from smarties_tpu_torch.runtime import graphs

CELL_B = 128
# the kernel's and the float32 plain version's distance to the float64
# chain, over the largest magnitude of each compared tensor: float32
# rounding through 17 positions of 2 layers and, for the gradients, sums
# over 16 positions and 128 rows in another order than the chain's
OUT_TOL, GRAD_TOL = 2e-6, 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _rel(got, want) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _f32(tree, device):
    return tnet.tree_map(
        lambda x: x.detach().float().to(device).requires_grad_(True), tree)


def _case(hidden, n_in, W, B, device):
    spec = cases.spec_of(hidden, n_in)
    p64 = cases.params_of(spec, seed=11)
    xs, active = cases.window(n_in, W, seed=12, B=B)
    cot = cases.cotangent(spec, xs.shape[0], seed=13)
    return spec, p64, xs, active, cot


@pytest.mark.cuda
@pytest.mark.parametrize("hidden, n_in, W, B", [
    ((32, 32), 3, 16, CELL_B), ((32, 32), 3, 4, None),
    ((16, 24), 5, 1, None), ((16, 24), 5, 16, None), ((8,), 2, 4, None),
    ((8,), 2, 16, None)])
def test_kernel_against_plain_and_float64_chain(cuda, hidden, n_in, W, B):
    spec, p64, xs, active, cot = _case(hidden, n_in, W, B, cuda)
    want = cases.outputs_and_grads(p64, spec, xs, active, cot, False)
    h64 = cases.chain_h(p64, spec, xs, active)

    p32 = _f32(p64, cuda)
    x32, a32, c32 = xs.float().to(cuda), active.to(cuda), cot.float().to(cuda)
    cuda_lib.reset_launches()
    got = cases.outputs_and_grads(p32, spec, x32, a32, c32, True)
    assert lw.launches == {"forward": 1, "backward": 1, "reduce": 1}
    h_t, h_t1 = lw.lstm_window(x32, a32, p32["layers"])
    torch.cuda.synchronize()

    # the plain version in float32 on the card, for scale
    leaves = [layer[k].detach() for layer in p32["layers"]
              for k in lw.LEAVES]
    pt, pt1, saved, prev = lw.forward_plain(x32, a32, leaves)
    g_h = torch.autograd.grad(
        tnet.apply_out(p32, spec, pt.requires_grad_(True)), pt, c32)[0]
    plain = lw.backward_plain(x32, a32, leaves, saved, prev, g_h)
    assert lw.launches["forward"] == 2

    errs = {"y_t": _rel(got[0], want[0]), "y_t1": _rel(got[1], want[1]),
            "h_t": _rel(h_t, h64[0]), "h_t1": _rel(h_t1, h64[1])}
    for i, (g, w) in enumerate(zip(got[2], want[2])):
        errs[f"grad{i}"] = _rel(g, w)
    plain_errs = {"h_t": _rel(pt, h64[0]), "h_t1": _rel(pt1, h64[1])}
    # the plain version's gradients against the kernel's, leaf by leaf
    # (the tree's order sorts a layer's leaves by name)
    by_leaf = {id(p): g for p, g in zip(tnet.tree_leaves(p32), got[2])}
    for li, layer in enumerate(p32["layers"]):
        for k, name in enumerate(lw.LEAVES):
            plain_errs[f"{li}{name}"] = _rel(
                plain[li * len(lw.LEAVES) + k], by_leaf[id(layer[name])])
    print(hidden, n_in, W, "kernel vs float64:", max(errs.values()),
          "plain vs float64 and kernel:", max(plain_errs.values()))
    for k in ("y_t", "y_t1", "h_t", "h_t1"):
        assert errs[k] <= OUT_TOL, (k, errs[k])
    for k, e in errs.items():
        if k.startswith("grad"):
            assert e <= GRAD_TOL, (k, e)
    assert max(plain_errs.values()) <= GRAD_TOL, plain_errs


def _cell(cuda):
    spec, p64, xs, active, cot = _case((32, 32), 3, 16, CELL_B, cuda)
    return (spec, _f32(p64, cuda), xs.float().to(cuda), active.to(cuda),
            cot.float().to(cuda))


def _step(spec, params, xs, active, cot):
    y_t, y_t1 = base.window_outputs(params, spec, xs, active)
    grads = base.backprop(params, y_t, cot)
    return [y_t.detach(), y_t1, *tnet.tree_leaves(grads)]


@pytest.mark.cuda
def test_calls_bit_equal_and_captured_replay_equal(cuda):
    spec, params, xs, active, cot = _cell(cuda)
    first = [x.clone() for x in _step(spec, params, xs, active, cot)]
    second = [x.clone() for x in _step(spec, params, xs, active, cot)]
    assert all(torch.equal(a, b) for a, b in zip(first, second))

    cuda_lib.reset_launches()
    graph = graphs.Graph(
        lambda st: (st, _step(spec, params, xs, active, cot)), params,
        device=cuda)
    calls = graphs.WARMUP_CALLS + 3
    for _ in range(calls):
        out = graph()
    torch.cuda.synchronize()
    assert graph.graph is not None
    assert lw.launches == {"forward": calls, "backward": calls,
                           "reduce": calls}
    assert all(torch.equal(a, b) for a, b in zip(out, first))


@pytest.mark.cuda
def test_no_grad_forward(cuda):
    spec, params, xs, active, _ = _cell(cuda)
    h_t, h_t1 = lw.lstm_window(xs, active, params["layers"])
    cuda_lib.reset_launches()
    with torch.no_grad():
        n_t, n_t1 = lw.lstm_window(xs, active, params["layers"])
    target = base.target_copy(params)
    d_t, _ = lw.lstm_window(xs, active, target["layers"])
    assert lw.launches == {"forward": 2, "backward": 0, "reduce": 0}
    assert n_t.grad_fn is None and d_t.grad_fn is None
    assert torch.equal(n_t, h_t) and torch.equal(n_t1, h_t1)
    assert torch.equal(d_t, h_t)


@pytest.mark.cuda
@pytest.mark.parametrize("kind, hidden, used", [
    ("LSTM", (32, 32), True), ("GRU", (32, 32), False),
    ("RNN", (32, 32), False), ("LSTM", (128,), False)])
def test_dispatch_on_the_card(cuda, kind, hidden, used):
    spec = tnet.NetSpec(n_in=3, hidden=hidden, n_out=3, kind=kind)
    params = tnet.init_params(torch.Generator().manual_seed(0), spec,
                              device=cuda)
    xs, active = cases.window(3, 16, seed=5, B=CELL_B, dtype=torch.float32,
                              device=cuda)
    cuda_lib.reset_launches()
    y_t, _ = base.seq_outputs(params, spec, xs, active)
    base.backprop(params, y_t, torch.ones_like(y_t))
    torch.cuda.synchronize()
    n = int(used)
    assert lw.launches == {"forward": n, "backward": n, "reduce": n}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "leaves_on_cpu"])
def test_card_refusals(cuda, case):
    spec, params, xs, active, _ = _cell(cuda)
    layers = params["layers"]
    if case == "float64":
        xs = xs.double()
        layers = [{k: v.double() for k, v in layer.items()}
                  for layer in layers]
    else:
        layers = [{k: v.detach().cpu() for k, v in layer.items()}
                  for layer in layers]
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="lstm_window_kernel"):
        lw.lstm_window(xs, active, layers)
    assert lw.launches == {"forward": 0, "backward": 0, "reduce": 0}

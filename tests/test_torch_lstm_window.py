"""The LSTM's BPTT window (ops/lstm_window_kernel.py) on the CPU: its
plain version, the dispatch in algos/base.py::seq_outputs and the wrapper
of its CUDA kernel before any build or launch.

On the card tests/test_torch_lstm_window_cuda.py holds the kernel itself
against the plain version and the float64 chain. Here:

- base.window_outputs through the plain version (the window's
  torch.autograd.Function on CPU tensors) against the autograd chain
  (base.chain_outputs, then backprop) in float64: the outputs at t and
  t+1, the top layer's h at both and every leaf's gradient, at LSTM [32,
  32] over 3 inputs, [16, 24] over 5 and [8] over 2, with W = 1, 4 and
  16, on windows whose rows hold every position active, inactive
  prefixes of 1 to W positions (t itself inactive in the last), only t
  and t+1 active, and holes; in float32 within float32's rounding;
- the no-grad forward (torch.no_grad, a target copy's leaves) saves
  nothing and gives the grad forward's outputs;
- `takes` on LSTM, GRU, RNN, FFNN, conv and oversized specs, and the
  forward block never needing more shared memory than the backward's;
- seq_outputs on CPU tensors keeps the chain;
- the wrapper's refusals, raised before any build.

This file imports neither jax nor the JAX package.
"""
import pytest
import torch

import _torch_lstm_window_cases as cases
from smarties_tpu_torch.algos import base
from smarties_tpu_torch.models import net as tnet
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import lstm_window_kernel as lw

torch.set_num_threads(1)


def _assert_close(got, want, rtol, atol, what):
    torch.testing.assert_close(got.detach().double(), want.detach().double(),
                               rtol=rtol, atol=atol, msg=what)


def _compare(hidden, n_in, W, dtype, rtol, atol):
    spec = cases.spec_of(hidden, n_in)
    p64 = cases.params_of(spec, seed=7)
    xs, active = cases.window(n_in, W, seed=8)
    cot = cases.cotangent(spec, xs.shape[0], seed=9)
    y_t, y_t1, grads = cases.outputs_and_grads(p64, spec, xs, active, cot,
                                               window_path=False)
    h_t, h_t1 = cases.chain_h(p64, spec, xs, active)

    params = tnet.tree_map(
        lambda x: x.detach().to(dtype).requires_grad_(True), p64)
    x, c = xs.to(dtype), cot.to(dtype)
    w_t, w_t1, w_grads = cases.outputs_and_grads(params, spec, x, active, c,
                                                 window_path=True)
    assert w_t1.grad_fn is None and not w_t1.requires_grad
    k_t, k_t1 = lw.lstm_window(x, active, params["layers"])
    for name, got, want in (("y_t", w_t, y_t), ("y_t1", w_t1, y_t1),
                            ("h_t", k_t, h_t), ("h_t1", k_t1, h_t1)):
        _assert_close(got, want, rtol, atol, name)
    names = [k for k, _ in _leaf_names(p64)]
    assert len(w_grads) == len(grads) == len(names)
    for name, got, want in zip(names, w_grads, grads):
        _assert_close(got, want, rtol, atol, name)


def _leaf_names(tree, prefix=""):
    """(path, leaf) in tree_leaves order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaf_names(tree[k], f"{prefix}{k}.")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _leaf_names(x, f"{prefix}{i}.")
        return out
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("W", cases.WINDOWS)
@pytest.mark.parametrize("hidden, n_in", cases.SHAPES)
def test_plain_window_is_the_chain(hidden, n_in, W):
    """float64: two orders of the same sums agree to rounding."""
    _compare(hidden, n_in, W, torch.float64, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("hidden, n_in", cases.SHAPES)
def test_plain_window_float32_against_float64_chain(hidden, n_in):
    _compare(hidden, n_in, 16, torch.float32, rtol=1e-5, atol=1e-6)


def test_masks_cover_the_cases():
    """The windows of the comparisons hold the masks they claim."""
    active = cases.masks(17, 0, 1)
    P = 17
    assert bool(active[0].all())
    assert any(not r[P - 2] and r[P - 1] and not r[:P - 2].any()
               for r in active)
    assert any(r[P - 2] and r[P - 1] and not r[:P - 2].any()
               for r in active)
    # a row with an inactive position after an active one
    assert any(bool((r[1:] & ~r[:-1]).any()) and bool((~r[1:] & r[:-1])
                                                      .any())
               for r in active)


def test_no_grad_forward_saves_nothing(monkeypatch):
    spec = cases.spec_of((16, 24), 5)
    params = cases.params_of(spec, seed=3, dtype=torch.float32)
    xs, active = cases.window(5, 4, seed=4, dtype=torch.float32)
    saves = []
    plain = lw.forward_plain

    def spy(xs, active, leaves, save=True):
        saves.append(save)
        return plain(xs, active, leaves, save)

    monkeypatch.setattr(lw, "forward_plain", spy)
    h_t, h_t1 = lw.lstm_window(xs, active, params["layers"])
    assert saves == [True] and h_t.requires_grad
    with torch.no_grad():
        n_t, n_t1 = lw.lstm_window(xs, active, params["layers"])
    d_t, d_t1 = lw.lstm_window(xs, active,
                               base.target_copy(params)["layers"])
    assert saves == [True, False, False]
    assert n_t.grad_fn is None and d_t.grad_fn is None
    for x in (n_t, d_t):
        assert torch.equal(x, h_t.detach())
    for x in (n_t1, d_t1):
        assert torch.equal(x, h_t1)


@pytest.mark.parametrize("kind, hidden, n_in, conv, want", [
    ("LSTM", (32, 32), 3, False, True),
    ("LSTM", (32, 32), 64, False, True),
    ("LSTM", (32, 32), 324, False, True),
    ("LSTM", (32, 32), 325, False, False),
    ("LSTM", (16, 24), 5, False, True),
    ("LSTM", (8,), 2, False, True),
    ("LSTM", (64, 64), 4, False, True),
    ("LSTM", (64, 64), 5, False, False),
    ("LSTM", (128,), 3, False, False),
    ("LSTM", (8,) * 9, 3, False, False),
    ("LSTM", (32, 32), 3, True, False),
    ("GRU", (32, 32), 3, False, False),
    ("RNN", (32, 32), 3, False, False),
    ("FFNN", (32, 32), 3, False, False)])
def test_takes(kind, hidden, n_in, conv, want):
    desc = (tnet.Conv2DDesc(in_w=8, in_h=8, in_c=1, out_c=2, filter=4,
                            stride=4),)
    spec = tnet.NetSpec(n_in=64 if conv else n_in, hidden=hidden, n_out=2,
                        kind=kind, conv=desc if conv else ())
    assert lw.takes(spec) is want


@pytest.mark.parametrize("hidden, n_in", [
    ((32, 32), 3), ((32, 32), 324), ((16, 24), 5), ((8,), 399),
    ((64, 64), 4), ((5, 7, 3), 11)])
def test_forward_block_needs_no_more_than_the_backward(hidden, n_in):
    """`takes` checks the backward's shared memory alone."""
    assert 0 < lw.smem_bytes(n_in, hidden, False) \
        <= lw.smem_bytes(n_in, hidden, True)


def test_seq_outputs_on_the_cpu_keeps_the_chain(monkeypatch):
    def refuse(*args):
        raise AssertionError("the window's kernel path on CPU tensors")

    monkeypatch.setattr(lw, "lstm_window", refuse)
    spec = cases.spec_of((32, 32), 3)
    assert lw.takes(spec)
    params = cases.params_of(spec, seed=5, dtype=torch.float32)
    xs, active = cases.window(3, 4, seed=6, dtype=torch.float32)
    y_t, y_t1 = base.seq_outputs(params, spec, xs, active)
    c_t, c_t1 = base.chain_outputs(params, spec, xs, active)
    assert torch.equal(y_t, c_t) and torch.equal(y_t1, c_t1)


def _refusal_case(case):
    spec = cases.spec_of((8, 8), 3)
    params = cases.params_of(spec, seed=1, dtype=torch.float32)
    layers = [{k: v.detach() for k, v in layer.items()}
              for layer in params["layers"]]
    xs, active = cases.window(3, 4, seed=2, dtype=torch.float32)
    if case == "float16":
        xs = xs.half()
    elif case == "xs_requires_grad":
        xs = xs.clone().requires_grad_(True)
    elif case == "xs_not_contiguous":
        xs = torch.cat([xs, xs], dim=2)[:, :, ::2]
    elif case == "active_not_bool":
        active = active.to(torch.int32)
    elif case == "active_shape":
        active = active[:, :-1]
    elif case == "leaf_shape":
        layers[1]["Rf"] = torch.zeros((8, 9))
    elif case == "leaf_dtype":
        layers[0]["bo"] = layers[0]["bo"].double()
    elif case == "two_devices":
        layers[0]["Wc"] = layers[0]["Wc"].to("meta")
    elif case == "one_position":
        xs, active = xs[:, :1], active[:, :1]
    elif case == "no_rows":
        xs, active = xs[:0], active[:0]
    elif case == "too_many_layers":
        layers = layers + [layers[1]] * 8
    elif case == "too_wide":
        h = 257
        layers = [{k: torch.zeros((3, h) if k[0] == "W" else
                                  (h, h) if k[0] == "R" else (h,))
                   for k in lw.LEAVES}]
    return xs, active, layers


@pytest.mark.parametrize("case", [
    "float16", "xs_requires_grad", "xs_not_contiguous", "active_not_bool",
    "active_shape", "leaf_shape", "leaf_dtype", "two_devices",
    "one_position", "no_rows", "too_many_layers", "too_wide"])
def test_wrapper_refuses_before_any_build(case):
    xs, active, layers = _refusal_case(case)
    before = dict(lw.launches)
    with pytest.raises(ValueError, match="lstm_window_kernel"):
        lw.lstm_window(xs, active, layers)
    assert not lw.LIB.loaded and lw.launches == before
    assert lw.LIB in cuda_lib.LIBRARIES

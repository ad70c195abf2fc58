"""K1 on the card: the CUDA kernel against its plain torch version.

Marked `cuda`: skipped where torch sees no CUDA card. This file imports
neither jax nor the JAX package, so it runs on a machine without them;
there, skip the repository's conftest (which configures jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Every entry point, row-major and time-major layouts, Retrace and GAE, at
the shapes of tests/test_pallas_retrace.py; rtol/atol 1e-4 as there
(chip_smoke.py runs the same checks at the main path's [4096, 501]).
The time-major pipeline and the in-place sweep keep the plain version's
operations in its order, so those are held to torch.equal: slot counts
that are no multiple of 32, lengths 0 and L1-1, a select of all, some
and no slots.

Two more checks need the card though they hold no kernel of the port's
own: the conv stack (cuDNN, channels_last) against the CPU, forward and
gradients at the Mnih shapes with TF32 off (rtol 1e-4 / atol 1e-5: sums
of up to 3136 f32 products in another order), and the inverse-CDF draw
on the card against the CPU at 2^21 categories (equal).
"""
import numpy as np
import pytest
import torch

from smarties_tpu_torch.ops import retrace_kernel as rk
from smarties_tpu_torch.ops import returns as tret

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(seed, E, L1, dev, time_major):
    rng = np.random.RandomState(seed)

    def f32(x):
        t = torch.tensor(np.asarray(x, np.float32), device=dev)
        return t.t().contiguous().t() if time_major else t

    r, V, A = (f32(rng.randn(E, L1)) for _ in range(3))
    rho = f32(np.exp(rng.randn(E, L1)))
    lens = torch.tensor(rng.randint(1, L1, E), dtype=torch.int32, device=dev)
    terms = torch.tensor(rng.rand(E) > 0.5, device=dev)
    return r, V, A, rho, lens, terms


@pytest.mark.cuda
@pytest.mark.parametrize("time_major", [False, True])
@pytest.mark.parametrize("shape", [(200, 37), (33, 22)])
def test_kernel_matches_plain(cuda, shape, time_major):
    args = _inputs(0, *shape, cuda, time_major)
    for mode in ("retrace", "GAE"):
        n0 = rk.launches["batched_retrace"]
        got = rk.batched_retrace(*args, 0.995, 0.95, mode)
        assert rk.launches["batched_retrace"] == n0 + 1
        assert got.stride() == args[0].stride()
        want = tret.batched_retrace_plain(*args, 0.995, 0.95, mode)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL)
    b = args[3] * 0.1
    torch.testing.assert_close(rk.affine_suffix_scan(args[0], b),
                               tret.affine_suffix_scan_plain(args[0], b),
                               **TOL)


@pytest.mark.cuda
def test_kernel_rejects_mixed_layouts(cuda):
    r, V, A, rho, lens, terms = _inputs(1, 16, 9, cuda, False)
    with pytest.raises(ValueError):
        rk.batched_retrace(r.t().contiguous().t(), V, A, rho, lens, terms,
                           0.995, 0.95, "retrace")
    with pytest.raises(ValueError):
        rk.batched_retrace(r, V, A, rho, lens.long(), terms, 0.995, 0.95,
                           "retrace")


def _sweep_inputs(seed, E, L1, dev):
    """Time-major replay fields with lengths 0 and L1-1 among them."""
    rng = np.random.RandomState(seed)

    def f32(*shape):
        return torch.tensor(rng.randn(*shape).astype(np.float32), device=dev)

    lens = rng.randint(0, L1, E)
    lens[:3] = [0, L1 - 1, min(1, L1 - 1)]
    return dict(
        qret=f32(L1, E), r=f32(L1, E), v=f32(L1, E), adv=f32(L1, E),
        rho=torch.exp(f32(L1, E)), v_trunc=f32(E),
        lens=torch.tensor(lens, dtype=torch.int32, device=dev),
        terms=torch.tensor(rng.rand(E) > 0.5, device=dev),
        mean=torch.full((), 0.3, device=dev),
        scale=torch.full((), 1.7, device=dev), rng=rng)


def _sweep(fn, f, qret, select, mode, zero):
    return fn(qret, f["r"], f["v"], f["adv"], f["rho"], f["v_trunc"],
              f["lens"], f["terms"], select, f["mean"], f["scale"], 0.995,
              0.95, mode, zero)


@pytest.mark.cuda
@pytest.mark.parametrize("zero_unselected", [False, True])
@pytest.mark.parametrize("mode", ["retrace", "GAE"])
@pytest.mark.parametrize("shape", [(33, 22), (200, 37), (64, 70), (5, 1)])
def test_sweep_matches_plain(cuda, shape, mode, zero_unselected):
    E, L1 = shape
    f = _sweep_inputs(2, E, L1, cuda)
    selects = (torch.tensor(f["rng"].rand(E) > 0.5, device=cuda),
               torch.zeros(E, dtype=torch.bool, device=cuda),
               torch.ones(E, dtype=torch.bool, device=cuda))
    for select in selects:
        got, want = f["qret"].clone(), f["qret"].clone()
        n0 = rk.launches["retrace_sweep"]
        out = _sweep(rk.retrace_sweep_, f, got, select, mode,
                     zero_unselected)
        assert rk.launches["retrace_sweep"] == n0 + 1
        assert out is got
        _sweep(tret.retrace_sweep_plain_, f, want, select, mode,
               zero_unselected)
        torch.cuda.synchronize()
        assert torch.equal(got, want), float((got - want).abs().max())
        if not zero_unselected:     # unselected rows are left as they were
            assert torch.equal(got[:, ~select], f["qret"][:, ~select])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(33, 22), (200, 37), (64, 70), (5, 1)])
def test_pipeline_is_exact_and_equals_the_loop(cuda, shape):
    """Time-major input: the async-copy pipeline, the same kernel's plain
    loop and the plain torch version agree to the last bit."""
    E, L1 = shape
    f = _sweep_inputs(3, E, L1, cuda)
    a, b = f["r"].t(), (f["rho"] * 0.1).t()
    want = tret.affine_suffix_scan_plain(a, b)
    for pipelined in (True, False):
        assert torch.equal(rk.affine_suffix_scan(a, b, pipelined=pipelined),
                           want)
    for mode in ("retrace", "GAE"):
        args = (f["r"].t(), f["v"].t(), f["adv"].t(), f["rho"].t(),
                f["lens"], f["terms"], 0.995, 0.95, mode)
        want = tret.batched_retrace_plain(*args)
        for pipelined in (True, False):
            got = rk.batched_retrace(*args, pipelined=pipelined)
            torch.cuda.synchronize()
            assert got.t().is_contiguous()      # time-major, as the input
            assert torch.equal(got, want), (mode, pipelined)


@pytest.mark.cuda
def test_sweep_rejects_unsupported_input(cuda):
    f = _sweep_inputs(4, 16, 9, cuda)
    select = torch.ones(16, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError):     # a transposed (slot-major) field
        _sweep(rk.retrace_sweep_, dict(f, r=f["r"].t().contiguous().t()),
               f["qret"], select, "retrace", False)
    with pytest.raises(ValueError):     # reward scalars on the host
        _sweep(rk.retrace_sweep_, dict(f, mean=torch.tensor(0.3)),
               f["qret"], select, "retrace", False)
    with pytest.raises(ValueError):
        _sweep(rk.retrace_sweep_, f, f["qret"], select.to(torch.uint8),
               "retrace", False)
    with pytest.raises(ValueError):
        _sweep(rk.retrace_sweep_, f, f["qret"], select, "retraceExplore",
               False)


@pytest.mark.cuda
def test_conv_stack_on_the_card_matches_the_cpu(cuda):
    from smarties_tpu_torch.models import net
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conv = tuple(net.Conv2DDesc(*c) for c in (
        (84, 84, 4, 32, 8, 4), (20, 20, 32, 64, 4, 2), (9, 9, 64, 64, 3, 1)))
    spec = net.NetSpec(n_in=4 * 84 * 84, hidden=(512,), n_out=13, conv=conv)
    cpu = net.init_params(torch.Generator().manual_seed(0), spec)
    card = net.tree_map(
        lambda x: x.detach().to(cuda).requires_grad_(True), cpu)
    rng = np.random.RandomState(0)
    x = torch.tensor(((rng.randint(0, 256, (8, spec.n_in)) - 128) / 64.0
                      ).astype(np.float32))
    c = torch.tensor(rng.randn(8, 13).astype(np.float32))
    outs = []
    for params, dev in ((cpu, "cpu"), (card, cuda)):
        y, _ = net.apply_net(params, spec, x.to(dev))
        torch.sum(y * c.to(dev)).backward()
        outs.append(y.detach().cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-4, atol=1e-5)
    for g, w in zip(net.tree_leaves(card), net.tree_leaves(cpu)):
        torch.testing.assert_close(g.grad.cpu(), w.grad, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
def test_inverse_cdf_draw_on_the_card_matches_the_cpu(cuda):
    from smarties_tpu_torch.replay import buffer as rb
    rng = np.random.RandomState(1)
    p = rng.rand(1 << 21).astype(np.float32)
    p[rng.rand(1 << 21) < 0.5] = 0.0
    p = torch.tensor(p / p.sum())
    u = torch.tensor(rng.rand(4096).astype(np.float32))
    want = rb.draw_from_probs(p, u)
    got = rb.draw_from_probs(p.to(cuda), u.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert bool((p[want] > 0).all())

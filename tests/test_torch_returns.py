"""Port parity: the return estimators and K1's plain version.

K1's plain torch version (ops/returns.py) against the JAX package's
Pallas kernel run in interpret mode on the CPU, at the shapes of
tests/test_pallas_retrace.py (off any tiling). The recursion runs the
same f32 operations in the same order; rtol/atol 1e-4 as that test uses
(500-step sweeps accumulate rounding), and the JAX Pallas path is
additionally held to 1e-4 against the JAX sequential scan there.

The wrapper (ops/retrace_kernel.py) must take the plain path for CPU
tensors without touching the CUDA library, and count no launch. The
kernel itself is checked on the card (chip_smoke.py, and the cuda-marked
tests/test_torch_kernel_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smarties_tpu.ops.pallas_retrace import (affine_suffix_scan,
                                             batched_retrace_pallas)
from smarties_tpu.ops.returns import (batched_return_estimate,
                                      episode_return_estimate)
from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.ops import retrace_kernel as rk
from smarties_tpu_torch.ops import returns as tret

from _torch_parity import np32, tn, tt

TOL = dict(rtol=1e-4, atol=1e-4)


def _retrace_inputs(seed, E, L1):
    rng = np.random.RandomState(seed)
    r, V, A = (np32(rng.randn(E, L1)) for _ in range(3))
    rho = np32(np.exp(rng.randn(E, L1)))
    lens = rng.randint(1, L1, E).astype(np.int32)
    lens[:2] = [L1 - 1, 1]                 # length == L and the shortest
    terms = rng.rand(E) > 0.5
    return r, V, A, rho, lens, terms


def _torch_args(r, V, A, rho, lens, terms):
    return (tt(r), tt(V), tt(A), tt(rho), tt(lens, torch.int32),
            tt(terms, torch.bool))


def test_affine_suffix_scan_plain_vs_pallas():
    rng = np.random.RandomState(0)
    E, L1 = 200, 37
    a = np32(rng.randn(E, L1))
    b = np32(rng.rand(E, L1) * 0.9)
    want = np.asarray(affine_suffix_scan(jnp.asarray(a), jnp.asarray(b),
                                         interpret=True))
    got = tn(tret.affine_suffix_scan_plain(tt(a), tt(b)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["retrace", "GAE"])
def test_batched_retrace_plain_vs_pallas(mode):
    """Coefficients (incl. the roll and the length == L bootstrap), scan
    and mask at [33, 22] against batched_retrace_pallas and the JAX
    sequential per-episode recursion."""
    r, V, A, rho, lens, terms = _retrace_inputs(1, 33, 22)
    want = np.asarray(batched_retrace_pallas(
        jnp.asarray(r), jnp.asarray(V), jnp.asarray(A), jnp.asarray(rho),
        jnp.asarray(lens), jnp.asarray(terms), 0.995, 0.95, mode,
        interpret=True))
    got = tn(rk.batched_retrace(*_torch_args(r, V, A, rho, lens, terms),
                                0.995, 0.95, mode))
    np.testing.assert_allclose(got, want, **TOL)
    for e in (0, 1, 10, 32):
        ep = np.asarray(episode_return_estimate(
            jnp.asarray(r[e]), jnp.asarray(V[e]), jnp.asarray(A[e]),
            jnp.asarray(rho[e]), jnp.asarray(lens[e]),
            jnp.asarray(terms[e]), 0.995, 0.95, mode))
        np.testing.assert_allclose(got[e], ep, **TOL)


def test_retrace_coeffs_match():
    from smarties_tpu.ops.pallas_retrace import retrace_coeffs
    r, V, A, rho, lens, terms = _retrace_inputs(2, 17, 12)
    for mode in ("retrace", "GAE"):
        ja, jb = retrace_coeffs(jnp.asarray(r), jnp.asarray(V),
                                jnp.asarray(A), jnp.asarray(rho),
                                jnp.asarray(lens), jnp.asarray(terms),
                                0.995, 0.95, mode)
        ta, tb = tret.retrace_coeffs(*_torch_args(r, V, A, rho, lens, terms),
                                     0.995, 0.95, mode)
        np.testing.assert_allclose(tn(ta), np.asarray(ja), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tn(tb), np.asarray(jb), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("mode", ["retrace", "GAE", "retraceExplore"])
def test_episode_and_sequential_estimators(mode):
    """episode_return_estimate (one slot) and the batched sequential
    recursion against the JAX sequential scan, all three modes."""
    r, V, A, rho, lens, terms = _retrace_inputs(3, 9, 16)
    targs = _torch_args(r, V, A, rho, lens, terms)
    want = np.asarray(batched_return_estimate(
        jnp.asarray(r), jnp.asarray(V), jnp.asarray(A), jnp.asarray(rho),
        jnp.asarray(lens), jnp.asarray(terms), 0.995, 0.95, mode,
        err_baseline=0.3, prefer_pallas=False))
    seq = tn(tret.sequential_returns(*targs, 0.995, 0.95, mode,
                                     err_baseline=0.3))
    np.testing.assert_allclose(seq, want, **TOL)
    batched = tn(tret.batched_return_estimate(*targs, 0.995, 0.95, mode,
                                              err_baseline=0.3))
    np.testing.assert_allclose(batched, want, **TOL)
    for e in (0, 4, 8):
        one = tret.episode_return_estimate(
            targs[0][e], targs[1][e], targs[2][e], targs[3][e],
            targs[4][e], targs[5][e], 0.995, 0.95, mode, err_baseline=0.3)
        np.testing.assert_allclose(tn(one), want[e], **TOL)


def test_cpu_branch_uses_plain_version_and_counts_nothing():
    cuda_lib.reset_launches()
    r, V, A, rho, lens, terms = _retrace_inputs(4, 33, 22)
    args = _torch_args(r, V, A, rho, lens, terms)
    q = rk.batched_retrace(*args, 0.995, 0.95, "retrace")
    assert torch.equal(q, tret.batched_retrace_plain(*args, 0.995, 0.95,
                                                     "retrace"))
    a = tt(np.random.RandomState(5).randn(33, 22))
    assert torch.equal(rk.affine_suffix_scan(a, a * 0.5),
                       tret.affine_suffix_scan_plain(a, a * 0.5))
    assert rk.launches == {"affine_suffix_scan": 0, "batched_retrace": 0,
                           "retrace_sweep": 0}
    assert not rk.LIB.loaded       # nothing compiled or loaded on the CPU


def test_time_major_views_give_the_same_result():
    """The replay hands the wrapper [E, L1] views of time-major storage;
    the CPU branch computes the same values as for row-major input."""
    r, V, A, rho, lens, terms = _retrace_inputs(6, 20, 15)
    rowm = _torch_args(r, V, A, rho, lens, terms)
    tmaj = tuple(x.t().contiguous().t() for x in rowm[:4]) + rowm[4:]
    assert not tmaj[0].is_contiguous() and tmaj[0].t().is_contiguous()
    np.testing.assert_array_equal(
        tn(rk.batched_retrace(*tmaj, 0.995, 0.95, "retrace")),
        tn(rk.batched_retrace(*rowm, 0.995, 0.95, "retrace")))


def test_wrapper_rejects_unsupported_input():
    r, V, A, rho, lens, terms = _retrace_inputs(7, 8, 6)
    args = list(_torch_args(r, V, A, rho, lens, terms))
    with pytest.raises(ValueError):
        rk.batched_retrace(*args, 0.995, 0.95, "retraceExplore")
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError):
        rk.batched_retrace(*meta, 0.995, 0.95, "retrace")
    with pytest.raises(ValueError):
        rk.affine_suffix_scan(meta[0], meta[1])

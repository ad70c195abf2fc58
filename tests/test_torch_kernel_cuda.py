"""K1 on the card: the CUDA kernel against its plain torch version.

Marked `cuda`: skipped where torch sees no CUDA card. This file imports
neither jax nor the JAX package, so it runs on a machine without them;
there, skip the repository's conftest (which configures jax):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Both entry points, row-major and time-major layouts, Retrace and GAE, at
the shapes of tests/test_pallas_retrace.py; rtol/atol 1e-4 as there
(chip_smoke.py runs the same checks at the main path's [4096, 501]).
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

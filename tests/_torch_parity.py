"""Shared helpers of the tests/test_torch_*.py parity suite.

The JAX package (smarties_tpu) is the reference; the torch port
(smarties_tpu_torch) is held against it on identical inputs made from a
seed with numpy. Data crosses between the two frameworks as numpy.
"""
import numpy as np
import torch

from smarties_tpu_torch.models.convert import REPLAY_FIELDS

# The suite runs beside the JAX tests in parallel workers, some of which
# time forked env processes; at these small sizes torch gains nothing from
# a thread per core, so keep it from crowding the other workers.
torch.set_num_threads(1)


def np32(x):
    return np.asarray(x, np.float32)


def tt(x, dtype=torch.float32):
    """numpy (or a jax array) -> CPU torch tensor, copied."""
    return torch.as_tensor(np.array(x)).to(dtype)


def tn(x):
    """torch tensor -> numpy."""
    return x.detach().cpu().numpy()


def jax_replay_views(rs):
    """numpy field views of a JAX ReplayState under REPLAY_FIELDS (the
    input of smarties_tpu_torch.models.convert.replay_from_jax)."""
    return {k: np.asarray(getattr(rs, k)) for k in REPLAY_FIELDS}


def assert_replay_close(rs_jax, rs_port, rtol, atol, fields=REPLAY_FIELDS):
    """Every field view of the port's replay against the JAX one."""
    from smarties_tpu_torch.models.convert import replay_to_numpy
    want = jax_replay_views(rs_jax)
    got = replay_to_numpy(rs_port)
    for k in fields:
        w, g = want[k], got[k]
        assert w.shape == g.shape, (k, w.shape, g.shape)
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=k)


def assert_tree_close(got, want, rtol, atol):
    """Nested dict/list of torch tensors (port) against numpy/jax (JAX)."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert_tree_close(got[k], want[k], rtol, atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_tree_close(g, w, rtol, atol)
    else:
        np.testing.assert_allclose(tn(got), np.asarray(want), rtol=rtol,
                                   atol=atol)

"""ops/cuda_lib.py on the CPU: the libraries' build names, the launch
counters' registry, and how a capture (runtime/graphs.py) takes back
what it counted.

The .so name hashes a library's nvcc flags and sources, so a pinned
name says that the flags and the sources are the ones the name was taken
from: an edit to either is a rebuild, and should be one on purpose. No
nvcc is needed to compute a name, and nothing is built or loaded here.
"""
import importlib
import os

import pytest

from smarties_tpu_torch.ops import cuda_lib
from smarties_tpu_torch.runtime import graphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("module, name", [
    ("retrace_kernel", "libsmt_retrace_3d533e4b368a5f0e.so"),
    ("adam_kernel", "libsmt_adam_08c1919e30c7bfc3.so"),
    ("step_tail_kernel", "libsmt_step_tail_a22b129c5e4b30b1.so"),
    ("stamp", "libsmt_stamp_6c301da00b3935f0.so"),
    ("policy_head_kernel", "libsmt_policy_head_045743156c111fd9.so"),
    ("lstm_window_kernel", "libsmt_lstm_window_e8421bdf633ee245.so")])
def test_library_name_is_pinned(module, name):
    lib = importlib.import_module(f"smarties_tpu_torch.ops.{module}").LIB
    assert lib in cuda_lib.LIBRARIES
    assert lib.path == os.path.join(REPO, "build", "smarties_tpu_torch",
                                    name)
    assert not lib.loaded


def test_reset_launches_zeroes_every_registered_counter():
    from smarties_tpu_torch.ops import (adam_kernel, lstm_window_kernel,
                                        policy_head_kernel, retrace_kernel,
                                        step_tail_kernel)
    own = {"site": 3}
    cuda_lib.register(own, own)
    try:
        assert sum(c is own for c in cuda_lib.COUNTERS) == 1
        wrappers = (retrace_kernel.launches, retrace_kernel.launch_modes,
                    adam_kernel.launches, step_tail_kernel.launches,
                    policy_head_kernel.launches, lstm_window_kernel.launches)
        assert all(any(w is c for c in cuda_lib.COUNTERS) for w in wrappers)
        for counts in cuda_lib.COUNTERS:
            for k in counts:
                counts[k] += 2
        cuda_lib.reset_launches()
        assert own == {"site": 0}
        assert all(n == 0 for c in cuda_lib.COUNTERS for n in c.values())
    finally:
        cuda_lib.COUNTERS[:] = [c for c in cuda_lib.COUNTERS if c is not own]


def test_capture_takes_back_counts_by_identity():
    """What counters gained during a capture is taken back and returned
    per dict, whatever their place in the registry: a dict registered
    during the capture counts from zero, and one registered in front of
    the others shifts nothing."""
    old, sites, late = {"a": 1}, {}, {"b": 0}
    cuda_lib.register(old, sites)
    try:
        before = graphs._counts_now()
        old["a"] += 2
        sites["ingest"] = 1
        cuda_lib.COUNTERS.insert(0, late)
        late["b"] += 5
        deltas = {id(c): d for c, d in graphs._take_back(before)}
        assert deltas[id(old)] == {"a": 2} and old == {"a": 1}
        assert deltas[id(sites)] == {"ingest": 1} and sites == {}
        assert deltas[id(late)] == {"b": 5} and late == {"b": 0}
    finally:
        cuda_lib.COUNTERS[:] = [c for c in cuda_lib.COUNTERS
                                if not any(c is x for x in (old, sites,
                                                            late))]

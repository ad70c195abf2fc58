"""The port's serving bench (smarties_tpu_torch/tools/serving_bench.py),
the twin of tools/serving_bench.py.

- Its fast app makes the same Communicator calls, in the same order and
  with the same arguments, as the JAX tool's (both driven through a
  recording stand-in for 450 actions: two terminal episodes of 200
  steps and the start of a third).
- 2 forked apps served for 1 s on the CPU: states were served, in
  rounds. No rate is asserted (forked, timed work shares the CPU with
  the other test workers).
- Without a card its command line raises.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

from smarties_tpu_torch.tools import serving_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Recorder:
    """A Communicator stand-in: records each call, answers recvAction
    with a zero action, and stops the app after `n_actions`."""

    def __init__(self, n_actions):
        self.calls, self.left = [], n_actions

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, tuple(
                tuple(np.asarray(a).ravel().tolist())
                if isinstance(a, (list, np.ndarray)) else a for a in args)))
            if name == "recvAction":
                self.left -= 1
                if self.left < 0:
                    raise StopIteration
                return np.zeros(1)
            return None
        return call


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_serving_bench", os.path.join(REPO, "tools", "serving_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)       # imports numpy only at top level
    return mod


def test_fast_app_matches_the_jax_tool():
    want, got = _Recorder(450), _Recorder(450)
    for app, rec in ((_jax_tool().fast_app, want),
                     (serving_bench.fast_app, got)):
        with pytest.raises(StopIteration):
            app(rec)
    assert got.calls == want.calls
    assert sum(c[0] == "sendTermState" for c in got.calls) == 2


def test_serves_forked_apps_on_cpu():
    res = serving_bench.serve(2, 1.0, "cpu")
    assert res["served"] > 0 and res["rounds"] > 0
    assert res["n_envs"] == 2 and res["seconds"] >= 1.0


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where no card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving_bench.main(["2", "1"])

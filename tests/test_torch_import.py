"""The port imports torch and numpy only: never jax, never smarties_tpu.

A fresh interpreter imports smarties_tpu_torch and every submodule and
reports what got loaded: no jax module, no module of the JAX package,
and no kernel library built or loaded at import time.
"""
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, pkgutil, sys
import smarties_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    smarties_tpu_torch.__path__, "smarties_tpu_torch."))
for n in names:
    __import__(n)
from smarties_tpu_torch.ops import retrace_kernel
print(json.dumps({
    "submodules": names,
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "reference": sorted(m for m in sys.modules
                        if m == "smarties_tpu"
                        or m.startswith("smarties_tpu.")),
    "kernel_loaded": retrace_kernel._lib is not None}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == [], res["jax"]
    assert res["reference"] == [], res["reference"]
    assert not res["kernel_loaded"]
    for sub in ("core.mdp", "ops.returns", "ops.retrace_kernel",
                "ops.continuous_policy", "ops.discrete_policy",
                "ops.advantages", "envs.cartpole", "envs.pendulum",
                "envs.acrobot", "envs.mountaincar", "envs.catch", "models.net",
                "models.optim", "models.convert", "replay.buffer",
                "replay.collector", "algos.base", "algos.vracer",
                "algos.dqn", "algos.naf", "algos.dpg", "algos.mixedpg",
                "algos.ppo",
                "algos.registry", "runtime.trainer", "runtime.profile_main",
                "runtime.bench_retrace", "utils.config", "utils.recipes", "launch"):
        assert "smarties_tpu_torch." + sub in res["submodules"], sub

"""The port imports torch and numpy only: never jax, never smarties_tpu.

A fresh interpreter imports smarties_tpu_torch and every submodule and
reports what got loaded: no jax module, no module of the JAX package,
no matplotlib (the learning-record tools import it inside `render` and
`--plot` only) and no kernel library built or loaded at import time.
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
from smarties_tpu_torch.ops import cuda_lib
import smarties_tpu_torch as pkg
lazy = sorted(n for n in ("Engine", "Communicator", "HyperParameters",
                          "MDPSpec") if getattr(pkg, n).__name__ == n)
print(json.dumps({
    "submodules": names,
    "lazy": lazy,
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", "jaxlib"))),
    "reference": sorted(m for m in sys.modules
                        if m == "smarties_tpu"
                        or m.startswith("smarties_tpu.")),
    "matplotlib": sorted(m for m in sys.modules
                         if m.split(".")[0] == "matplotlib"),
    "libraries": sorted(lib.stem for lib in cuda_lib.LIBRARIES),
    "kernel_loaded": any(lib.loaded for lib in cuda_lib.LIBRARIES)}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax"] == [], res["jax"]
    assert res["reference"] == [], res["reference"]
    assert res["matplotlib"] == [], res["matplotlib"]
    assert res["libraries"] == ["smt_adam", "smt_lstm_window",
                                "smt_policy_head", "smt_retrace", "smt_stamp",
                                "smt_step_tail"]
    assert not res["kernel_loaded"]
    for sub in ("core.mdp", "ops.returns", "ops.cuda_lib",
                "ops.retrace_kernel", "ops.stamp", "ops.adam_kernel",
                "ops.step_tail_kernel", "ops.policy_head_kernel",
                "ops.lstm_window_kernel", "ops.leaf_table",
                "ops.continuous_policy", "ops.discrete_policy",
                "ops.advantages", "envs.cartpole", "envs.pendulum",
                "envs.acrobot", "envs.mountaincar", "envs.catch",
                "envs.glider", "envs.predator_prey", "models.net",
                "models.optim", "models.convert", "replay.buffer",
                "replay.collector", "replay.multi_collector", "algos.base",
                "algos.vracer",
                "algos.dqn", "algos.naf", "algos.dpg", "algos.mixedpg",
                "algos.ppo", "algos.acer", "algos.cma", "algos.racer_es",
                "algos.registry", "runtime.trainer", "runtime.multitrainer",
                "runtime.profile_main",
                "runtime.bench_retrace", "runtime.engine",
                "runtime.env_pool", "runtime.socket_pool",
                "runtime.communicator", "runtime.team", "utils.config",
                "parallel.mesh", "parallel.multihost",
                "utils.recipes", "utils.stats", "utils.profiler", "launch",
                "tools.learning_curves", "tools.cma_func_max_record",
                "tools.lstm_endurance", "tools.plot_weights", "bench",
                "tools.serving_bench", "tools.submit"):
        assert "smarties_tpu_torch." + sub in res["submodules"], sub
    assert res["lazy"] == ["Communicator", "Engine", "HyperParameters",
                           "MDPSpec"]


_BARE = r"""
import json, sys
import smarties_tpu_torch
before = sorted(m for m in sys.modules if m.startswith("smarties_tpu_torch."))
engine = smarties_tpu_torch.Engine
print(json.dumps({"before": before, "engine": engine.__module__,
                  "jax": any(m == "jax" or m.startswith("smarties_tpu.")
                             for m in sys.modules)}))
"""


def test_package_import_is_bare_and_engine_lazy():
    """`import smarties_tpu_torch` loads no submodule; the Engine export
    loads the runtime on first access, and still no jax."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _BARE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"before": [], "engine": "smarties_tpu_torch.runtime.engine",
                   "jax": False}

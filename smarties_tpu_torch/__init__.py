"""smarties_tpu_torch — the PyTorch + CUDA port of smarties_tpu.

`smarties_tpu` re-expressed in PyTorch for an NVIDIA H100: the built-in
vectorized envs with their Trainer, and the external-env runtime (the
Engine serving user applications through the Communicator API). The
subpackages mirror `smarties_tpu/` module by module and function by
function (`core`, `ops`, `envs`, `models`, `replay`, `algos`,
`runtime`, `utils`), so a reader finds
`smarties_tpu_torch/replay/buffer.py::recompute_returns` where
`smarties_tpu/replay/buffer.py::recompute_returns` is.

The port imports torch and numpy only. It never imports jax or
`smarties_tpu`: the JAX package is the reference the port's tests hold
it against, and nothing more. Its one hand-written kernel is the Retrace
suffix scan (`ops/retrace_kernel.py`, `csrc/retrace.cu`), built with
nvcc at first use.

`Engine`, `Communicator`, `HyperParameters` and `MDPSpec` are exported
as in the JAX package (`smarties_tpu_torch.Engine(sys.argv)`), but
lazily (PEP 562): this file imports no submodule, so `import
smarties_tpu_torch` stays cheap and side-effect free.
"""

__version__ = "0.1.0"

_EXPORTS = {"Engine": "smarties_tpu_torch.runtime.engine",
            "Communicator": "smarties_tpu_torch.runtime.communicator",
            "HyperParameters": "smarties_tpu_torch.utils.config",
            "MDPSpec": "smarties_tpu_torch.core.mdp"}


def __getattr__(name):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_EXPORTS))

"""smarties_tpu_torch — the PyTorch + CUDA port of smarties_tpu.

The V-RACER cart-pole trainer of `smarties_tpu` re-expressed in PyTorch
for an NVIDIA H100. The subpackages mirror `smarties_tpu/` module by
module and function by function (`core`, `ops`, `envs`, `models`,
`replay`, `algos`, `runtime`, `utils`), so a reader finds
`smarties_tpu_torch/replay/buffer.py::recompute_returns` where
`smarties_tpu/replay/buffer.py::recompute_returns` is.

The port imports torch and numpy only. It never imports jax or
`smarties_tpu`: the JAX package is the reference the port's tests hold
it against, and nothing more. Its one hand-written kernel is the Retrace
suffix scan (`ops/retrace_kernel.py`, `csrc/retrace.cu`), built with
nvcc at first use.

This file imports no submodule, so `import smarties_tpu_torch` stays
cheap and side-effect free.
"""

__version__ = "0.1.0"

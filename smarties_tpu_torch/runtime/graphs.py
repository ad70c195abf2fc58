"""CUDA graphs of fixed-shape, sync-free steps: the port's `jax.jit`.

The JAX package compiles its main-path programs with jax.jit (the train
step and chunk, the rollout, the ingest sweep and the fused cycle,
smarties_tpu/runtime/trainer.py:134-207). PyTorch issues each kernel as
Python reaches it; a CUDA graph records the kernels of one call and
replays them with one launch. `Graph` wraps a function of a state,

    fn(state) -> (new_state, out)

where `state` is a tree of tensors that owns the storage (the trainer's
params, Adam state, replay, in-progress episodes, env state). Each call
of the Graph is one call of fn:

- on a CUDA device the first WARMUP_CALLS calls run fn eagerly on a side
  stream. They do the lazy set-up that a capture must not (cuBLAS
  handles and workspaces, K1's nvcc build and its shared-memory
  attribute, constants copied to the card once, autograd's state) and
  they are calls of the run like any other. The next call captures fn
  into a torch.cuda.CUDAGraph with a private memory pool and replays it;
  every later call replays;
- on the CPU fn runs as it is: the static-buffer form of the program a
  card captures, which the tests hold against the eager loops.

After fn, new_state's tensors are copied into state's (models/net.py::
tree_copy_), inside the graph, so every replay advances the same
storage; where fn updates in place there is nothing to copy. A replay
reads and writes only the addresses it captured: code outside the graph
copies into that storage and never rebinds it. `out` is the captured
call's output, rewritten by every replay: a caller that keeps it copies
it.

Random draws: the generators fn draws from are registered with the graph
(CUDAGraph.register_generator_state), so a replay draws from each
generator's current offset what an eager call would, and advances it as
much; a restored generator state (Generator.set_state) is what the next
replay reads. A replay writes each registered generator's seed and
offset with two small kernels of its own before the graph.

Launch counters: the dicts of ints registered in ops/cuda_lib.py's
COUNTERS (each kernel library's, and any a caller registers) count
device launches. What a capture adds to them is taken back, and added
again at every replay. A dict registered during the capture counts from
zero.

The garbage collector runs before a capture and not during it: freeing
another graph (a dropped trainer's) while a stream captures voids the
capture.

A capture that fails raises: nothing runs eagerly in its place.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Sequence

import torch

from smarties_tpu_torch.models.net import tree_copy_
from smarties_tpu_torch.ops import cuda_lib

# eager calls on the side stream before the capture
WARMUP_CALLS = 2


def _counts_now() -> dict:
    """The registered launch counters' values, by each dict's identity."""
    return {id(c): dict(c) for c in cuda_lib.COUNTERS}


def _take_back(before: dict) -> list:
    """Restore every registered counter to its value in `before` (a
    _counts_now(); a dict not in it to zero) and return what each gained
    since: [(counter, {key: gain})], the counters that gained."""
    deltas = []
    for counts in cuda_lib.COUNTERS:
        old = before.get(id(counts))
        if old is None:
            old = dict.fromkeys(counts, 0)
        delta = {k: n - old.get(k, 0) for k, n in counts.items()
                 if n != old.get(k, 0)}
        for k in delta:
            if k in old:
                counts[k] = old[k]
            else:
                del counts[k]
        if delta:
            deltas.append((counts, delta))
    return deltas


class Graph:
    """One captured program: fn(state) -> (new_state, out), called with
    no arguments (see the module docstring). `generators`: the device
    generators fn draws from. After the capture, `pool_bytes` is the
    device memory its private pool reserved."""

    def __init__(self, fn: Callable, state, *, device,
                 generators: Sequence[torch.Generator] = ()):
        self.fn = fn
        self.state = state
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.calls = 0
        self.graph = None
        self.out = None
        self.pool_bytes = 0
        self._deltas = []
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _run(self):
        new_state, out = self.fn(self.state)
        tree_copy_(self.state, new_state)
        return out

    def __call__(self):
        self.calls += 1
        if self._stream is None:
            return self._run()
        if self.graph is None:
            if self.calls <= WARMUP_CALLS:
                return self._on_side_stream(self._run)
            self._capture()
        self.replay()
        return self.out

    def _on_side_stream(self, fn):
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = fn()
        cur.wait_stream(self._stream)
        return out

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = _counts_now()
        # a graph that the collector frees during a capture (a dropped
        # trainer's, in a reference cycle) would void it: collect first,
        # and not during the capture
        gc.collect()
        reserved = torch.cuda.memory_reserved(self.device)

        def capture():
            graph.capture_begin()
            try:
                out = self._run()
            except BaseException:
                # the capture is void; its own error is the one to see
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
            return out

        collecting = gc.isenabled()
        gc.disable()
        try:
            out = self._on_side_stream(capture)
        finally:
            if collecting:
                gc.enable()
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        # what the capture counted is counted by the replays instead
        self._deltas = _take_back(before)
        self.graph, self.out = graph, out

    def replay(self):
        """One launch of the captured program on the current stream."""
        with torch.cuda.device(self.device):
            self.graph.replay()
        for counts, delta in self._deltas:
            for k, n in delta.items():
                counts[k] = counts.get(k, 0) + n

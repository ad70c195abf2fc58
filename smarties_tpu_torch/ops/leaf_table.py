"""Leaf tables of the hand-written kernels that take many tensors in one
launch (csrc/adam.cu, csrc/step_tail.cu): ctypes arrays of the leaves'
device pointers and element counts, which the C side copies into a
launch's parameters.

A captured step hands the same leaves at every call, so a table is
built once per set of pointers and sizes and kept for the `size` sets
seen last (least recently used first out)."""
from __future__ import annotations

import collections
import ctypes


class LeafTables:
    """get(ptrs, sizes, derive) -> (pointer array, size array,
    len(sizes), *derive(sizes)): `derive` adds what a kernel's wrapper
    computes once per table (its launches, its partials)."""

    def __init__(self, size: int = 64):
        self.size = size
        self._tables = collections.OrderedDict()

    def get(self, ptrs, sizes, derive):
        key = (*ptrs, *sizes)
        hit = self._tables.get(key)
        if hit is not None:
            self._tables.move_to_end(key)
            return hit
        hit = ((ctypes.c_void_p * len(ptrs))(*ptrs),
               (ctypes.c_longlong * len(sizes))(*sizes), len(sizes),
               *derive(sizes))
        self._tables[key] = hit
        if len(self._tables) > self.size:
            self._tables.popitem(last=False)
        return hit

    def __len__(self):
        return len(self._tables)

"""Phase profiler: named start/stop timers and a percent-of-total table.

Port of smarties_tpu/utils/profiler.py (reference Utils/Profiler.{h,cpp},
printed by Learner.cpp:135-145). The Trainer times its phases under the
keys ROLL (env sweeps and the at-ingest return sweep), TRAIN (chunks of
grad steps), REFRESH (the 1000-step sweeps) and HOST (writing the logs
that were deferred on the device).

On a CUDA device a host clock around a phase measures only its enqueue,
so each phase is timed with a pair of CUDA events recorded on the current
stream. Nothing waits for them while the cycle runs: the pairs are kept
and read when `table()` is called, which synchronises on the last event
(beyond 256 pairs, those the card has passed are folded in, which only
queries them). On the CPU the phases take perf_counter times.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch


class Profiler:
    def __init__(self, device="cpu"):
        self.cuda = torch.device(device).type == "cuda"
        self.totals = defaultdict(float)     # seconds, of read phases
        self.counts = defaultdict(int)
        self._open = {}
        self._events = []                    # (name, start, end) unread

    def start(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[name] = ev
        else:
            self._open[name] = time.perf_counter()

    def stop(self, name: str):
        t0 = self._open.pop(name, None)
        if t0 is None:
            return
        self.counts[name] += 1
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append((name, t0, ev))
            if len(self._events) > 256:
                self._fold_completed()
        else:
            self.totals[name] += time.perf_counter() - t0

    @contextmanager
    def __call__(self, name: str):
        self.start(name)
        try:
            yield
        finally:
            self.stop(name)

    def _fold_completed(self):
        """Fold the pairs whose end event the card has passed (a query,
        which does not wait), so that a long run keeps few events."""
        n = 0
        for _, _, e1 in self._events:
            if not e1.query():
                break
            n += 1
        for name, e0, e1 in self._events[:n]:
            self.totals[name] += e0.elapsed_time(e1) / 1e3
        del self._events[:n]

    def _read_events(self):
        """Fold the recorded event pairs into the totals (one wait, on
        the last event)."""
        if not self._events:
            return
        self._events[-1][2].synchronize()
        for name, e0, e1 in self._events:
            self.totals[name] += e0.elapsed_time(e1) / 1e3
        self._events = []

    def table(self) -> str:
        """Percent-of-total table (Profiler::printStatAndReset)."""
        self._read_events()
        total = sum(self.totals.values()) or 1.0
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f"  {k:>8s}: {v:8.3f}s {100 * v / total:5.1f}%"
                 f" ({self.counts[k]} calls)" for k, v in rows]
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self._events = []

"""Phase profiler: named start/stop timers and a percent-of-total table,
and, when tracing is on, span records on the host's clock.

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

TRACING (`trace()`, off by default; the hot path then pays one boolean
test per span). Every span keeps a record (`Span`): its name, its parent
(the innermost span open when it began), the cycle index (`cycle`, which
the Trainer advances once per fused cycle or train() chunk), its host
start and end (time.perf_counter_ns) and its device interval, from a
pair of CUDA events on the current stream. Besides the four phases, the
Trainer opens spans that enter no `totals` or `counts` (so the phases'
table and shares keep their meaning): PRESAMPLE (the chunk's index draw
and its copy into the step's pinned rows), STEP (one per graph replay),
METRICS (the copies of the step's metric rows) inside TRAIN, and LOGS
(the copies of the sweep's logs) inside ROLL. A traced grad step also
stamps the boundaries of its phases on the card (ops/stamp.py); the
Trainer hands the stamp rows to `add_stamps`, and each STEP record gets
its `phases`.

Device times are put on the host's clock through calibration pairs: with
the card idle, an event (or a stamp of the card's timer) is recorded
between two host readings, and taken at their midpoint. One pair is
taken when tracing is turned on and one at every `read()`; between pairs
the mapping is linear, so the two clocks' drift is followed. Its error is
measured (`mapping_error_ns`): the widest pair's half width, plus the
largest distance of a pair from the line through its neighbours. On the
CPU every op has ended when the next starts, so a span's device interval
is its host interval.

`export_chrome_trace` writes the records as a Chrome trace in the time
base of torch.profiler's `export_chrome_trace` (Unix time, less the
trace's `baseTimeNanoseconds`); given a torch.profiler trace (`onto`), it
writes the records into a copy of it, so the two lie on one time axis.
Each gap in the card's intervals is labelled there by the host span open
when the card resumed.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import statistics
import time
from collections import defaultdict

import torch

# the finest device intervals of a traced cycle: their union is the time
# the card is known to be busy (TRAIN is made of STEP, PRESAMPLE, METRICS
# and the host's loop between them)
BUSY_SPANS = ("STEP", "PRESAMPLE", "METRICS", "ROLL", "REFRESH", "HOST")
_NULL = contextlib.nullcontext()
# folded to raw times once this many records wait with their events
_FOLD_AT = 4096


class Span:
    """One traced span. parent: the index of the enclosing span in
    `Profiler.records` (-1: none); host0 / host1: perf_counter_ns (host1
    None while open); dev0 / dev1: its device interval on the host's
    clock (ns; None until `read()`); phases: [(name, start, end)] of a
    stamped STEP, on the host's clock."""
    __slots__ = ("name", "parent", "cycle", "host0", "host1", "dev0",
                 "dev1", "phases", "_ev", "_raw")

    def __init__(self, name, parent, cycle, host0):
        self.name, self.parent, self.cycle = name, parent, cycle
        self.host0, self.host1 = host0, None
        self.dev0 = self.dev1 = None
        self.phases = None
        self._ev = self._raw = None


def _map(x, xs, hs):
    """Host time of a device reading x, piecewise linear through the
    calibration points (xs, hs), extended past the ends."""
    if len(xs) == 1:
        return hs[0] + (x - xs[0])
    j = max(0, min(bisect.bisect_right(xs, x) - 1, len(xs) - 2))
    return hs[j] + (x - xs[j]) * (hs[j + 1] - hs[j]) / (xs[j + 1] - xs[j])


def _fit_error(xs, hs, halves) -> float:
    """The widest pair's half width, plus the largest distance of a
    calibration's host time from the line through its neighbours."""
    off = max((abs(hs[j] - _map(xs[j], [xs[j - 1], xs[j + 1]],
                                [hs[j - 1], hs[j + 1]]))
               for j in range(1, len(xs) - 1)), default=0.0)
    return max(halves, default=0.0) + off


def _narrowest(read, tries: int = 8, settle=None):
    """(h0, h1, value) of the try k whose host readings around read(k)
    lie closest together; settle() runs before each try, untimed."""
    best = None
    for k in range(tries):
        if settle is not None:
            settle()
        h0 = time.perf_counter_ns()
        v = read(k)
        h1 = time.perf_counter_ns()
        if best is None or h1 - h0 < best[1] - best[0]:
            best = (h0, h1, v)
    return best


class Profiler:
    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.totals = defaultdict(float)     # seconds, of read phases
        self.counts = defaultdict(int)
        self._open = {}
        self._events = []                    # (name, start, end) unread
        # tracing
        self.tracing = False
        self.cycle = 0
        self.records = []                    # Span, in order of start
        self._stack = []                     # indices of open records
        self._open_spans = {}                # start()'s name -> record
        self._unread = []                    # records with events unread
        self._stamps = []                    # [spans, names, times, raw]
        self.counters = {}                   # a stamped replay's counts
        # calibration: host ns, half width, device position (ns, chained
        # over the events), its event; the card's timer with its host ns
        # and half width; Unix time minus perf_counter
        self._cal = []
        self._mapped_with = 0                # pairs the records were mapped by

    # ------------------------------------------------------------------
    def start(self, name: str):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._open[name] = ev
        else:
            ev = None
            self._open[name] = time.perf_counter()
        if self.tracing:
            self._open_spans[name] = self.begin(name, ev)

    def stop(self, name: str):
        t0 = self._open.pop(name, None)
        if t0 is None:
            return
        self.counts[name] += 1
        ev = None
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events.append((name, t0, ev))
            if len(self._events) > 256:
                self._fold_completed()
        else:
            self.totals[name] += time.perf_counter() - t0
        span = self._open_spans.pop(name, None)
        if span is not None:
            self.end(span, ev)

    @contextlib.contextmanager
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
        """Clear the totals, counts and records (tracing stays as it is,
        and so do the calibration pairs)."""
        self.totals.clear()
        self.counts.clear()
        self._events = []
        self.records, self._stack, self._unread, self._stamps = [], [], [], []
        self._open_spans.clear()
        self.counters = {}

    # ------------------------------------------------------------------
    # tracing
    def trace(self, on: bool = True):
        """Turn tracing on (with a calibration pair: a synchronisation)
        or off."""
        if on:
            self._calibrate()
        self.tracing = on

    def begin(self, name: str, ev=None) -> Span:
        """Open a traced span (recorded whether or not tracing is on: the
        caller tests `tracing`); ev: its start event, if one was just
        recorded."""
        span = Span(name, self._stack[-1] if self._stack else -1,
                    self.cycle, time.perf_counter_ns())
        if self.cuda:
            if ev is None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            span._ev = (ev, None)
        self._stack.append(len(self.records))
        self.records.append(span)
        return span

    def end(self, span: Span, ev=None):
        """Close a span that `begin` opened; ev: its end event, if one was
        just recorded."""
        span.host1 = time.perf_counter_ns()
        if self.cuda:
            if ev is None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            span._ev = (span._ev[0], ev)
            self._unread.append(span)
            if len(self._unread) > _FOLD_AT:
                self._fold_spans(wait=False)
        else:
            span._raw = (span.host0, span.host1)
        for k in range(len(self._stack) - 1, -1, -1):
            if self.records[self._stack[k]] is span:
                del self._stack[k]
                break

    def span(self, name: str):
        """A traced span, in no totals or counts: a context manager that
        does nothing unless tracing is on."""
        if not self.tracing:
            return _NULL
        return self._span(name)

    @contextlib.contextmanager
    def _span(self, name):
        s = self.begin(name)
        try:
            yield s
        finally:
            self.end(s)

    def add_stamps(self, spans, names, times: torch.Tensor,
                   counters=None):
        """The phase stamps of `spans` (STEP records, in order): times
        [len(spans), len(names) + 1], row k the boundaries of span k's
        phases, in the stamp's clock (the card's timer; perf_counter_ns
        on the CPU). Kept on the device until `read()`. counters: what
        each of these replays counted (the same for every replay of a
        graph), e.g. "conv_macs": the multiply-adds of each conv of the
        forward, "bptt_cells" and "bptt_macs" those of a BPTT window
        (algos/base.py::bptt_counts)."""
        self._stamps.append([list(spans), tuple(names), times, None])
        self.counters.update(counters or {})

    def _calibrate(self):
        if not self.cuda:
            cal = {}
        else:
            from smarties_tpu_torch.ops.stamp import stamp_
            dev = self.device
            evs = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
            buf = torch.zeros((8, 1), dtype=torch.int64, device=dev)

            def event(k):
                evs[k].record()
                evs[k].synchronize()
                return evs[k]

            def timer(k):
                stamp_(buf[k:k + 1], None, 0)
                torch.cuda.synchronize(dev)
                return k

            def settle():
                torch.cuda.synchronize(dev)

            h0, h1, ev = _narrowest(event, settle=settle)
            x = 0.0
            if self._cal:
                prev = self._cal[-1]
                x = prev["x"] + prev["ev"].elapsed_time(ev) * 1e6
            g0, g1, k = _narrowest(timer, settle=settle)
            cal = {"host": (h0 + h1) / 2, "half": (h1 - h0) / 2, "x": x,
                   "ev": ev, "timer": int(buf[k, 0]),
                   "timer_host": (g0 + g1) / 2, "timer_half": (g1 - g0) / 2}
        r0, r1, real = _narrowest(lambda k: time.time_ns())
        cal["real_minus_host"] = real - (r0 + r1) / 2
        self._cal.append(cal)

    def _fold_spans(self, wait: bool):
        """Turn the events of closed spans into raw device positions (ns
        on the chained event axis of the calibration pairs), oldest
        first: all of them after a synchronisation (`wait`), else those
        the card has passed."""
        cal = [c for c in self._cal if "ev" in c]
        if not cal:
            return
        hosts = [c["host"] for c in cal]
        n = 0
        for span in self._unread:
            e0, e1 = span._ev
            if not wait and not e1.query():
                break
            c = cal[max(0, bisect.bisect_right(hosts, span.host0) - 1)]
            span._raw = (c["x"] + c["ev"].elapsed_time(e0) * 1e6,
                         c["x"] + c["ev"].elapsed_time(e1) * 1e6)
            span._ev = None
            n += 1
        del self._unread[:n]

    def read(self) -> list:
        """The records with their device intervals and phases on the
        host's clock (ns). On a card a synchronisation and one more
        calibration pair."""
        if self.cuda and (self._unread or any(s[3] is None
                                              for s in self._stamps)):
            torch.cuda.synchronize(self.device)
            self._calibrate()
            self._fold_spans(wait=True)
        # every record is mapped again once a new pair changes the line
        again = len(self._cal) != self._mapped_with
        self._mapped_with = len(self._cal)
        cal = [c for c in self._cal if "ev" in c]
        if self.cuda:
            xs = [c["x"] for c in cal]
            hs = [c["host"] for c in cal]
            gs = [c["timer"] for c in cal]
            ghs = [c["timer_host"] for c in cal]
        for span in self.records:
            if span._raw is not None and (again or span.dev0 is None):
                x0, x1 = span._raw
                span.dev0, span.dev1 = ((_map(x0, xs, hs), _map(x1, xs, hs))
                                        if self.cuda else (x0, x1))
        for entry in self._stamps:
            spans, names, times, raw = entry
            if raw is not None and not again:
                continue
            if raw is None:
                raw = entry[3] = times.cpu().tolist()
            for span, row in zip(spans, raw):
                if self.cuda:
                    row = [_map(g, gs, ghs) for g in row]
                span.phases = [(n, row[k], row[k + 1])
                               for k, n in enumerate(names)]
        return self.records

    def mapping_error_ns(self) -> float:
        """The measured error of the device-to-host mapping (0 on the
        CPU): the larger of the events' and the card timer's."""
        cal = [c for c in self._cal if "ev" in c]
        if not cal:
            return 0.0
        return max(
            _fit_error([c["x"] for c in cal], [c["host"] for c in cal],
                       [c["half"] for c in cal]),
            _fit_error([c["timer"] for c in cal],
                       [c["timer_host"] for c in cal],
                       [c["timer_half"] for c in cal]))

    # ------------------------------------------------------------------
    # readings of the records
    def _select(self, cycles, recs=None):
        recs = self.read() if recs is None else recs
        if cycles is None:
            return recs
        cycles = set(cycles)
        return [r for r in recs if r.cycle in cycles]

    def gaps(self, cycles=None) -> list:
        """The card's idle gaps between the device intervals of the
        BUSY_SPANS records (of `cycles`, default all), as (start, end,
        label) on the host's clock (ns): label is the innermost host span
        open when the card resumed ("none": the host was in no span)."""
        recs = self.read()
        sel = {id(r) for r in self._select(cycles, recs)}
        ivs = sorted((r.dev0, r.dev1) for r in recs
                     if id(r) in sel and r.name in BUSY_SPANS
                     and r.dev0 is not None)
        starts = [r.host0 for r in recs]
        out, end = [], None
        for a, b in ivs:
            if end is not None and a > end:
                c = bisect.bisect_right(starts, a) - 1
                while c >= 0 and recs[c].host1 is not None \
                        and recs[c].host1 < a:
                    c = recs[c].parent
                out.append((end, a, recs[c].name if c >= 0 else "none"))
            end = b if end is None else max(end, b)
        return out

    def summary(self, cycles=None) -> dict:
        """Readings of the traced cycles (`cycles`, default all): their
        window (the first to the last busy device interval, ms), the
        share of it outside every busy interval (device_gap_share, %),
        PRESAMPLE's device ms per cycle, the median STEP device ms and
        host µs, the median ms of each stamped phase, and the mapping's
        error (µs). A step with a conv stack adds its forward
        multiply-adds a replay (conv_macs) and the rate of the stack's
        FLOPs over the median conv_forward plus conv_backward ms
        (conv_tflop_s): 2 per multiply-add of the forward, the weight
        gradients and the input gradients of every conv but the first,
        whose input takes none. A recurrent step adds its window's cell
        applications a replay, forward and backward (bptt_cells), its
        forward cells' multiply-adds (bptt_macs) and the µs of one cell
        application over the median bptt_forward plus bptt_backward
        (bptt_cell_us)."""
        recs = self._select(cycles)
        busy = [r for r in recs if r.name in BUSY_SPANS
                and r.dev0 is not None]
        if not busy:
            return {}
        lo = min(r.dev0 for r in busy)
        hi = max(r.dev1 for r in busy)
        idle = sum(b - a for a, b, _ in self.gaps(cycles))
        n_cycles = len({r.cycle for r in recs})
        steps = [r for r in recs if r.name == "STEP"]
        phases = defaultdict(list)
        for r in steps:
            for name, a, b in r.phases or ():
                phases[name].append((b - a) / 1e6)
        med = statistics.median
        phases_ms = {k: med(v) for k, v in phases.items()}
        counted = {}
        macs = self.counters.get("conv_macs")
        if macs:
            counted["conv_macs"] = sum(macs)
            conv_ms = (phases_ms.get("conv_forward", 0.0)
                       + phases_ms.get("conv_backward", 0.0))
            if conv_ms > 0:
                counted["conv_tflop_s"] = (2 * (3 * sum(macs) - macs[0])
                                           / (conv_ms * 1e-3) / 1e12)
        cells = self.counters.get("bptt_cells")
        if cells:
            counted["bptt_cells"] = cells
            counted["bptt_macs"] = sum(self.counters["bptt_macs"])
            bptt_ms = (phases_ms.get("bptt_forward", 0.0)
                       + phases_ms.get("bptt_backward", 0.0))
            if bptt_ms > 0:
                counted["bptt_cell_us"] = bptt_ms * 1e3 / cells
        return {
            "cycles": n_cycles,
            "window_ms": (hi - lo) / 1e6,
            "device_gap_share": 100.0 * idle / (hi - lo) if hi > lo else 0.0,
            "presample_ms": sum(r.dev1 - r.dev0 for r in recs
                                if r.name == "PRESAMPLE") / 1e6 / n_cycles,
            "steps": len(steps),
            "step_ms": (med([(r.dev1 - r.dev0) / 1e6 for r in steps])
                        if steps else None),
            "step_host_us": (med([(r.host1 - r.host0) / 1e3 for r in steps])
                             if steps else None),
            "phases_ms": phases_ms,
            "mapping_error_us": self.mapping_error_ns() / 1e3,
            **counted,
        }

    def export_chrome_trace(self, path: str, onto: str | None = None):
        """Write the records as a Chrome trace (JSON) to `path`: host
        spans, device intervals, the stamped phases and the labelled
        gaps, as threads of this process. onto: a torch.profiler trace
        (its `export_chrome_trace`), copied into `path` with the records
        added in its time base."""
        recs = self.read()
        doc = {"traceEvents": []}
        if onto is not None:
            with open(onto) as f:
                doc = json.load(f)
        if not self._cal:
            self._calibrate()
        real = self._cal[-1]["real_minus_host"]
        if "baseTimeNanoseconds" in doc:
            base = doc["baseTimeNanoseconds"]
        elif onto is not None or not recs:
            base = 0
        else:
            base = int((recs[0].host0 + real) // 10 ** 9 * 10 ** 9)
            doc["baseTimeNanoseconds"] = base
        pid = os.getpid()
        tids = {"host": 1_000_001, "device": 1_000_002, "phases": 1_000_003,
                "gaps": 1_000_004}
        labels = {"host": "profiler spans (host)",
                  "device": "profiler spans (device)",
                  "phases": "grad step phases (device)",
                  "gaps": "device idle gaps"}
        events = doc["traceEvents"]
        for k, tid in tids.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": labels[k]}})

        def x(name, tid, a, b, args=None):
            events.append({"ph": "X", "cat": "smarties_profiler",
                           "name": name, "pid": pid, "tid": tids[tid],
                           "ts": (a + real - base) / 1e3,
                           "dur": (b - a) / 1e3, "args": args or {}})

        for r in recs:
            args = {"cycle": r.cycle,
                    "parent": recs[r.parent].name if r.parent >= 0 else ""}
            if r.host1 is not None:
                x(r.name, "host", r.host0, r.host1, args)
            if r.dev0 is not None:
                x(r.name, "device", r.dev0, r.dev1, args)
            for name, a, b in r.phases or ():
                x(name, "phases", a, b, {"cycle": r.cycle})
        for a, b, label in self.gaps():
            x("idle, host in " + label, "gaps", a, b)
        with open(path, "w") as f:
            json.dump(doc, f)

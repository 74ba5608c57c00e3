"""What the span readers share: the port's own span records and counters
(``climb_tpu_torch.utils.tracing``, recorded while the profiler captures)
laid over the trace, and the device time, idle time and launches charged to
each of the port's ``climb.*`` spans.

The records come from the port's tracing module, which this module imports
itself: ``program.py``, otherwise the one module of the harness that imports
the port, stays as it was when these readers were added beside it. A
program without that module, or a run whose records do not line up with the
trace, reads None.

``Trace`` keeps the harness's ``bench.*`` spans and every device operation
with its launch, but neither the program's spans nor the trace's base time,
so the records are laid over the trace in four steps:

1. ``snapshot()`` of the port's module: its span records, stamped by
   ``time.time_ns()``, and its counters.
2. The offset between the two clocks: the median over the window's steps of
   the start of ``bench.step`` less the start of its ``climb.train_step`` or
   ``climb.eval_step`` record, rounded to whole seconds (the trace's base
   time is a whole second). The window's step records are the last
   ``trace.steps`` of them: the profiler's warm-up steps come before. Each
   step record has to fall inside its ``bench.step`` (to ``SLACK_US``), or
   the records read None.
3. Each device operation of the window is charged to the spans open when it
   was launched, on any thread: kernels that autograd launches on its own
   thread fall inside ``climb.backward``.
4. Each idle gap is charged to the spans open when the operation that ends
   it was launched.

A span's numbers include its inner spans'.
"""

import bisect
import statistics
from collections import defaultdict

STEP_SPANS = ("climb.train_step", "climb.eval_step")
SLACK_US = 100  # how far the two clocks may disagree at a step's ends
_cache = {}


def port_snapshot():
    """The port's records and counters, or None without its tracing module."""
    try:
        from climb_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def offset_us(records, trace):
    """Microseconds to add to a record's ``time_ns`` / 1000 to place it on
    the trace's clock, or None where the step records do not line up."""
    steps = [r for r in records if r["name"] in STEP_SPANS][-trace.steps:]
    bench = sorted((s for s in trace.spans if s["name"] == "bench.step"), key=lambda s: s["ts"])
    if not steps or len(steps) != len(bench):
        return None
    raw = statistics.median(b["ts"] - r["start_ns"] / 1e3 for b, r in zip(bench, steps))
    offset = round(raw / 1e6) * 1e6
    for b, r in zip(bench, steps):
        start, end = r["start_ns"] / 1e3 + offset, r["end_ns"] / 1e3 + offset
        if start < b["ts"] - SLACK_US or end > b["ts"] + b["dur"] + SLACK_US:
            return None
    return offset


class Timeline:
    """The program's spans on the trace's clock: ``open_at(t)`` gives the
    names of the spans open at ``t``, outermost first."""

    def __init__(self, spans):
        bounds = sorted({t for s in spans for t in s[:2]})
        self.starts = bounds
        self.open = []
        for a in bounds:
            inside = sorted((s for s in spans if s[0] <= a < s[1]), key=lambda s: (s[0], -s[1]))
            self.open.append(tuple(name for _, _, name in inside))

    def open_at(self, t):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.open[i] if i >= 0 else ()


class Charges:
    """The window's device operations and idle gaps, each with the spans
    open at its launch."""

    def __init__(self, trace, records, offset):
        self.steps = trace.steps
        lo, hi = trace.start, trace.end
        spans = []
        for r in records:
            start, end = r["start_ns"] / 1e3 + offset, r["end_ns"] / 1e3 + offset
            if end >= lo and start <= hi:
                spans.append((start, end, r["name"]))
        timeline = Timeline(spans)
        self.ops = []  # (seconds, spans open at the launch)
        opened = {}
        for _, start, end, launch in trace.ops:
            where = timeline.open_at(launch["ts"]) if launch else ()
            self.ops.append(((end - start) / 1e6, where))
            opened.setdefault(start, where)
        self.gaps = []  # (seconds, spans open at the launch that ends the gap)
        last = trace.start
        for start, end in trace.busy_intervals() + [[trace.end, trace.end]]:
            if start > last:
                self.gaps.append(((start - last) / 1e6, opened.get(start, ())))
            last = max(last, end)

    def device_ms(self, span):
        """Device milliseconds a step launched inside ``span``."""
        return 1e3 * sum(s for s, where in self.ops if span in where) / self.steps

    def idle_ms(self, span):
        """Idle milliseconds a step ended by a launch inside ``span``."""
        return 1e3 * sum(s for s, where in self.gaps if span in where) / self.steps

    def launches(self, span):
        """Device operations a step launched inside ``span``."""
        return sum(1 for _, where in self.ops if span in where) / self.steps

    def by_innermost(self):
        """Device seconds of the window by the innermost span open at the
        launch ("" outside every span)."""
        out = defaultdict(float)
        for s, where in self.ops:
            out[where[-1] if where else ""] += s
        return dict(out)


def _read(r):
    """(the port's snapshot, its ``Charges``) of a reading, read once a
    trace; either may be None."""
    trace = r.trace
    if trace is None:
        return None, None
    key = id(trace)
    if key not in _cache or _cache[key][0] is not trace:
        snap = port_snapshot()
        result = None
        if snap is not None and snap["spans"]:
            offset = offset_us(snap["spans"], trace)
            if offset is not None:
                result = Charges(trace, snap["spans"], offset)
        _cache.clear()
        _cache[key] = (trace, snap, result)
    return _cache[key][1:]


def charges(r):
    """The ``Charges`` of a reading's trace, or None where there is no
    trace, no record of the port's or none that lines up with the trace."""
    return _read(r)[1]


def device_ms(r, span):
    c = charges(r)
    return c.device_ms(span) if c is not None and c.launches(span) else None


def idle_ms(r, span):
    c = charges(r)
    return c.idle_ms(span) if c is not None and c.launches(span) else None


def launches(r, span):
    c = charges(r)
    return c.launches(span) if c is not None and c.launches(span) else None


def pad_pct(r):
    """100 x (1 - valid tokens / token positions) of the encoder's joint
    sequence over the traced steps (the port counts while the profiler
    captures)."""
    snap = _read(r)[0]
    counters = snap["counters"] if snap is not None else {}
    if not counters.get("token_slots"):
        return None
    return 100.0 * (1.0 - counters.get("tokens", 0.0) / counters["token_slots"])

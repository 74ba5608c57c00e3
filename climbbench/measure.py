"""The timed window, the host-clock window and the traced window.

- ``timed_window``: steps dispatched back to back for a number of seconds,
  no synchronisation inside; a device event is recorded at the end of every
  step, so a step's time is the interval between consecutive step ends, and
  the window runs from a synchronisation before the first step to one after
  the last.
- ``host_window``: a fixed number of steps, each call into the program
  timed by the host clock (its enqueue time), the whole between two
  synchronisations.
- ``traced_window``: a fixed number of steps under ``torch.profiler``, with
  spans of the harness's own (``bench.window``, ``bench.step`` and any the
  driver opens) that the readers find in the trace.
"""

import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

from climbbench.trace import Trace


class Clock:
    """Device events on a card; the host clock, after a synchronisation, on
    the CPU (tests)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def ms(self, a, b):
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclass
class Window:
    steps: int = 0
    seconds: float = 0.0
    step_ms: list = field(default_factory=list)
    host_s: list = field(default_factory=list)


def timed_window(step, seconds, clock):
    clock.sync()
    marks = [clock.mark()]
    start = time.perf_counter()
    n = 0
    while True:
        step(n)
        n += 1
        marks.append(clock.mark())
        if time.perf_counter() - start >= seconds:
            break
    clock.sync()
    end = time.perf_counter()
    return Window(n, end - start, [clock.ms(a, b) for a, b in zip(marks, marks[1:])])


def host_window(step, steps, first, clock):
    clock.sync()
    spans = []
    start = time.perf_counter()
    for i in range(first, first + steps):
        t = time.perf_counter()
        step(i)
        spans.append(time.perf_counter() - t)
    clock.sync()
    return Window(steps, time.perf_counter() - start, host_s=spans)


PROFILER_WARM_STEPS = 2  # traced but outside the window: the profiler's own start-up


def traced_window(step, steps, first, clock, counters, warm=PROFILER_WARM_STEPS):
    """Run ``warm`` steps, then ``steps`` steps inside the span
    ``bench.window``, under the profiler; returns the parsed ``Trace`` and
    how far each of ``counters()`` moved over the window's steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if clock.cuda else [])
    with profile(activities=activities) as prof:
        for i in range(first, first + warm):
            step(i)
        clock.sync()
        before = counters()
        with record_function("bench.window"):
            for i in range(first + warm, first + warm + steps):
                with record_function("bench.step"):
                    step(i)
            clock.sync()
        moved = {k: v - before.get(k, 0) for k, v in counters().items()}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, steps), moved

"""Spans and counters at the boundaries of the port's steps, recorded exactly
while a ``torch.profiler`` captures.

The recorder has two states and no switch of its own:

- While no profiler captures, ``span(name)`` reads one flag and returns a
  shared no-op context manager, and the counters do nothing.
- While a profiler captures (``--profile_dir``'s ``StepProfiler``, or any
  ``torch.profiler.profile``), ``span(name)`` opens
  ``torch.profiler.record_function(name)``, so the span shows in the Chrome
  trace as a ``user_annotation`` (never as a host operator), and appends a
  record to a bounded in-memory buffer: the name, the enclosing span of the
  same thread, the thread's native id (the trace's ``tid``), and the start
  and end by ``time.time_ns()``, taken just outside the profiler's range. A
  Chrome trace's ``ts`` (microseconds) plus its ``baseTimeNanoseconds`` is
  that same clock, so the records can be laid over the trace's device
  operations.

Spans do nothing while ``torch.compile`` or ``torch.export`` traces, so
exported programs hold no profiler op. The port's spans are named
``climb.<phase>``:

- ``climb.train_step``, ``climb.eval_step``: one call of a step;
- ``climb.prepare_batch``, ``climb.forward``, ``climb.loss``,
  ``climb.backward`` (kernels that autograd launches on its own thread fall
  inside it in time), ``climb.optimizer``, ``climb.metric``: the phases of a
  step;
- ``climb.text_encoder`` (ViLT-BERT's frozen BERT), ``climb.embed`` (text
  and image embeddings to the attention mask), ``climb.encoder`` (the
  layers, the final LayerNorm and the pooler), ``climb.head``: the model;
- ``climb.data_wait`` (waiting on the loader) and ``climb.h2d_copy``
  (enqueueing the copies to the card and handing a batch over), in
  ``data/loader.py``'s ``device_prefetch``;
- ``climb.log``: the trainer's logging, where reading the metrics waits
  for the device.

Counters: ``tokens`` (the joint mask's valid positions, summed on the
device) and ``token_slots`` (its positions), counted in ``climb.embed``.
"""

import contextlib
import threading
import time
from collections import deque

import torch

MAX_RECORDS = 1 << 16  # span records kept; the oldest go first
MAX_PARTS = 1 << 10  # device values a counter keeps before it folds them into one

_profiler_enabled = torch.autograd._profiler_enabled


NOOP = contextlib.nullcontext()  # what ``span`` returns while nothing records


def recording() -> bool:
    """True while a profiler captures, outside compile and export tracing."""
    return _profiler_enabled() and not torch.compiler.is_compiling()


class Recorder:
    """The span records and counters of one process."""

    def __init__(self):
        self.records = deque(maxlen=MAX_RECORDS)
        self.host = {}
        self.device = {}
        self.lock = threading.Lock()
        self.local = threading.local()

    def open_spans(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def count(self, name: str, n: int):
        with self.lock:
            self.host[name] = self.host.get(name, 0) + n

    def count_on_device(self, name: str, value: torch.Tensor):
        with self.lock:
            parts = self.device.setdefault(name, [])
            parts.append(value.detach())
            if len(parts) >= MAX_PARTS:
                parts[:] = [_total(parts)]

    def snapshot(self) -> dict:
        with self.lock:
            spans = list(self.records)
            host = dict(self.host)
            totals = {name: _total(parts) for name, parts in self.device.items()}
        device = {}
        if totals:  # one read of every device counter
            first = next(iter(totals.values())).device
            values = torch.stack([t.to(first) for t in totals.values()]).tolist()
            device = dict(zip(totals, values))
        return {"spans": spans, "counters": {**host, **device}}

    def reset(self):
        with self.lock:
            self.records.clear()
            self.host.clear()
            self.device.clear()


def _total(parts) -> torch.Tensor:
    return torch.stack([p.to(torch.float64) for p in parts]).sum()


class _Span:
    __slots__ = ("name", "parent", "function", "start")

    def __init__(self, name: str):
        self.name = name

    # the stamps lie just outside the profiler's range, so the record holds
    # every launch the range holds
    def __enter__(self):
        stack = _RECORDER.open_spans()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.function = torch.profiler.record_function(self.name)
        self.start = time.time_ns()
        self.function.__enter__()
        return self

    def __exit__(self, *exc):
        self.function.__exit__(*exc)
        end = time.time_ns()
        _RECORDER.open_spans().pop()
        _RECORDER.records.append({"name": self.name, "parent": self.parent,
                                  "tid": threading.get_native_id(),
                                  "start_ns": self.start, "end_ns": end})
        return False


_RECORDER = Recorder()


def span(name: str):
    """A context manager around one phase: the shared no-op unless a
    profiler captures."""
    if not _profiler_enabled() or torch.compiler.is_compiling():
        return NOOP
    return _Span(name)


def count(name: str, n: int):
    """Add the host integer ``n`` to counter ``name`` while recording."""
    if recording():
        _RECORDER.count(name, int(n))


def count_on_device(name: str, value: torch.Tensor):
    """Add the device scalar ``value`` to counter ``name`` while recording,
    with no synchronisation: it is read by ``snapshot``."""
    if recording():
        _RECORDER.count_on_device(name, value)


def snapshot() -> dict:
    """``{"spans": [record, ...], "counters": {name: value}}``, oldest
    record first; reads the device counters once."""
    return _RECORDER.snapshot()


def reset():
    """Forget every record and counter."""
    _RECORDER.reset()

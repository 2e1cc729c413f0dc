"""Tracing and step timing: the port's one tracing module.

* `span(name, **attrs)`: a context manager around one piece of the work
  (the train step's phases, the loader's threads). A span records its name,
  start and end on `time.perf_counter`, its thread, the span that encloses
  it on that thread (its parent) and its attributes, in a bounded buffer in
  memory (`spans()`, `reset()`). Spans record only while a torch profiler
  records in the process, or after `enable()`. While a profiler records, a
  span of the main thread (the thread that starts the profiler and drives
  the card) also enters `record_function("tinyfaces.<name>")`, which puts
  it into the profiler's trace on the device events' clock; other threads'
  spans are only in the buffer (an annotation of theirs would not reach
  the trace and would cost each ~25 us). Off, a span reads two flags and
  records nothing.
* `trace(logdir)`: context manager around `torch.profiler` (host and, when
  a GPU is present, device activity) that writes a Chrome trace
  `<logdir>/trace.json` and the spans it covered, every thread's,
  `<logdir>/spans.json`; a no-op without a logdir (`main.py --profile-dir`).
* `StepTimer`: wall-clock per-step timing with warmup discard; reports
  steps/sec and items/sec. The same meter as tinyfaces_tpu/utils/
  profiling.py (tests/test_torch_imports.py holds the two alike).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Iterator, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "tinyfaces."  # of each span's record_function annotation
MAX_SPANS = 1 << 16  # a 51 s traced train window makes ~15k


class Span(NamedTuple):
    name: str
    start: float  # time.perf_counter(), seconds
    end: float
    thread: str  # the recording thread's name
    id: int
    parent: Optional[int]  # id of the enclosing span on the same thread
    attrs: dict


_enabled = False
_buffer: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = threading.local()  # per thread: the ids of its open spans
_MAIN = threading.main_thread()
_OFF = contextlib.nullcontext()


def enable(on: bool = True) -> None:
    """Record spans whether or not a profiler records (tests, operators)."""
    global _enabled
    _enabled = on


def spans() -> list[Span]:
    """The recorded spans, oldest first by end; the oldest are dropped past
    MAX_SPANS."""
    return list(_buffer)


def reset() -> None:
    _buffer.clear()


def span(name: str, **attrs):
    """Record the enclosed work as the span `name` with `attrs`; an
    attribute given as a callable is called when the span starts (a
    reading that costs something, taken only while spans record)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Recorded(name, attrs)


class _Recorded:
    """One recording span (a class, not a generator: the loader's threads
    open ~30 a step)."""

    __slots__ = ("name", "attrs", "id", "parent", "stack", "thread", "annotation", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> None:
        stack = getattr(_open, "ids", None)
        if stack is None:
            stack = _open.ids = []
        self.stack = stack
        self.id = next(_ids)
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.thread = threading.current_thread()
        self.attrs = {k: v() if callable(v) else v for k, v in self.attrs.items()}
        self.annotation = None
        if _autograd_profiler._is_profiler_enabled and self.thread is _MAIN:
            self.annotation = torch.profiler.record_function(PREFIX + self.name)
            self.annotation.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.stack.pop()
        _buffer.append(Span(self.name, self.t0, t1, self.thread.name, self.id, self.parent,
                            self.attrs))


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace and its spans when a logdir is given;
    no-op otherwise."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
    covered = [s._asdict() for s in spans() if s.start >= t0]
    (out / "spans.json").write_text(json.dumps({"clock": "time.perf_counter, s", "spans": covered}))


class StepTimer:
    """Running throughput meter.

    >>> timer = StepTimer(warmup=2)
    >>> for batch in data:
    ...     step(batch); timer.tick(items=batch_size)
    >>> timer.items_per_sec
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self.reset()

    def reset(self) -> None:
        self._count = 0
        self._items = 0
        self._t0 = None
        self._last = None

    def tick(self, items: int = 1) -> None:
        now = time.perf_counter()
        self._count += 1
        self._last = now
        if self._count == self.warmup:
            self._t0 = now
            self._items = 0
        elif self._count > self.warmup:
            self._items += items

    @property
    def measured_steps(self) -> int:
        return max(0, self._count - self.warmup)

    @property
    def elapsed(self) -> float:
        if self._t0 is None or self._last is None:
            return 0.0
        return self._last - self._t0

    @property
    def steps_per_sec(self) -> float:
        return self.measured_steps / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def items_per_sec(self) -> float:
        return self._items / self.elapsed if self.elapsed > 0 else 0.0

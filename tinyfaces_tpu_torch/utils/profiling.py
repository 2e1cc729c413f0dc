"""Tracing and step timing.

* `trace(logdir)`: context manager around `torch.profiler` (host and, when
  a GPU is present, device activity) that writes a Chrome trace
  `<logdir>/trace.json`; a no-op without a logdir (`main.py --profile-dir`).
* `StepTimer`: wall-clock per-step timing with warmup discard; reports
  steps/sec and items/sec. The same meter as tinyfaces_tpu/utils/
  profiling.py (tests/test_torch_imports.py holds the two alike).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str] = None) -> Iterator[None]:
    """Capture a torch.profiler trace when a logdir is given; no-op otherwise."""
    if not logdir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


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

"""CUDA graphs: the port's one module that captures and replays them
(`Captured`, the warm-up's `side_stream`) and counts the hand kernels'
launches (`count_launch`, `launches`), replays included. Two callers
capture: the train step (trainer.TrainSteps, one graph of the step) and
the compiled pyramid (evaluation.GraphCache, one graph per ProgramKey);
when each captures, and what it keeps, is the caller's.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Callable, Optional

import torch

_launches: collections.Counter = collections.Counter()  # kernel -> launches run
_lock = threading.Lock()
_capturing = threading.local()  # .tally: the Captured this thread captures


def _stream_capturing() -> bool:
    try:
        return torch.cuda.is_current_stream_capturing()
    except RuntimeError:  # a CPU build of torch has no streams to capture
        return False


def count_launch(kernel: str) -> None:
    """One launch of `kernel` on the current stream: counted now, or, in a
    capture, into the capturing graph's tally (a capture that no
    `Captured` makes counts nowhere: nothing replays it through here)."""
    if _stream_capturing():
        tally = getattr(_capturing, "tally", None)
        if tally is not None:
            tally[kernel] += 1
        return
    with _lock:
        _launches[kernel] += 1


def launches(kernel: str) -> int:
    """Launches of `kernel` run in this process, replays included."""
    return _launches[kernel]


def launch_counts(prefix: str) -> dict:
    """Launches run in this process, replays included, of every kernel
    whose name starts with `prefix` ("sdpa." for the attention calls)."""
    with _lock:
        return {k: n for k, n in sorted(_launches.items()) if k.startswith(prefix)}


def _empty_like(inputs, device: torch.device):
    if isinstance(inputs, torch.Tensor):
        return torch.empty_like(inputs, device=device)
    if isinstance(inputs, dict):
        return {k: _empty_like(v, device) for k, v in inputs.items()}
    return tuple(_empty_like(v, device) for v in inputs)


def _copy_in(static, inputs) -> None:
    if isinstance(static, torch.Tensor):
        static.copy_(inputs, non_blocking=True)
    elif isinstance(static, dict):
        for k, v in static.items():
            _copy_in(v, inputs[k])
    else:
        for s, x in zip(static, inputs):
            _copy_in(s, x)


def _in_pool(pool: Optional[torch.cuda.MemPool], device: torch.device):
    return contextlib.nullcontext() if pool is None else torch.cuda.use_mem_pool(pool, device)


class Captured:
    """`fn(*static)` captured into a CUDA graph on `device`, where `static`
    are copies of `inputs` (tensors, or dicts and tuples of them),
    allocated in `pool` when given; the capture runs on `stream` (else
    torch's capture stream) into `pool`. Capture mode `thread_local`: the
    capture checks this thread's CUDA calls alone, so other threads may go
    on pinning host memory and querying events meanwhile. `capture_s` is
    the capture's seconds, `tally` the hand kernels' launches it recorded.
    Every replay's inputs are shaped as the first call's."""

    def __init__(self, fn: Callable, *inputs, device: torch.device,
                 stream: Optional[torch.cuda.Stream] = None, pool: Optional[torch.cuda.MemPool] = None):
        with _in_pool(pool, device):
            self.static = _empty_like(inputs, device)
        _copy_in(self.static, inputs)
        self.tally: collections.Counter = collections.Counter()
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        _capturing.tally = self.tally
        try:
            with torch.cuda.graph(self.graph, pool=None if pool is None else pool.id, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = fn(*self.static)
        finally:
            _capturing.tally = None
        self.capture_s = time.perf_counter() - t0

    def replay(self, *inputs):
        """Copy `inputs` into the static buffers, replay, and return the
        static outputs (the next replay overwrites them)."""
        _copy_in(self.static, inputs)
        self.graph.replay()
        with _lock:
            _launches.update(self.tally)
        return self.out


@contextlib.contextmanager
def side_stream(device: torch.device, stream: Optional[torch.cuda.Stream] = None,
                pool: Optional[torch.cuda.MemPool] = None):
    """Run the enclosed work on `stream` (else a new side stream of the
    card) after the current stream's work, with its allocations in `pool`
    when given, and make the current stream wait for it after. Off a card
    the work runs as it is."""
    if device.type != "cuda":
        yield
        return
    current = torch.cuda.current_stream(device)
    stream = stream or torch.cuda.Stream(device)
    stream.wait_stream(current)
    try:
        with torch.cuda.stream(stream), _in_pool(pool, device):
            yield
    finally:
        current.wait_stream(stream)

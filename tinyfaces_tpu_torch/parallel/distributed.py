"""Stop handling of a training run (port of
tinyfaces_tpu/parallel/distributed.py:56-90, for one process).

`GracefulStop` turns SIGTERM into a stop at the next epoch boundary, where
the CLI writes a checkpoint before it exits. Across processes the JAX
package agrees on the stop with an allgather, so that every rank stops at
the same boundary; multi-process training is ROADMAP item 13, so here
`agreed()` is the local flag.
"""

from __future__ import annotations

import signal


class GracefulStop:
    """SIGTERM -> stop after the current epoch. Use as a context manager:
    the previous handlers come back on exit. Signal handlers can only be
    installed from the main thread."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._previous = {s: signal.signal(s, self._handler) for s in signals}

    def _handler(self, signum, frame):
        print(f"signal {signum}: will checkpoint and stop after this epoch", flush=True)
        self._flag = True

    def agreed(self) -> bool:
        """The stop decision at an epoch boundary; with one process, the
        local flag."""
        return self._flag

    def close(self) -> None:
        for s, previous in self._previous.items():
            signal.signal(s, previous)
        self._previous = {}

    def __enter__(self) -> "GracefulStop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

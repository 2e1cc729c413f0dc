"""Multi-process run control on torch.distributed (port of
tinyfaces_tpu/parallel/distributed.py).

The JAX package jits one step over a batch sharded across every process,
and XLA inserts the gradient psum and the cross-device BatchNorm statistics.
Here each process runs its rows of the global batch and the same two
reductions are explicit: `all_reduce_sum` inside BatchNorm (differentiable)
and `all_reduce_tensors` over the gradients, both SUM, so world-N computes
what world-1 computes on the same global batch.

  * `initialize` starts the process group: NCCL when the tensors live on
    CUDA, gloo on the CPU, unless `backend` says otherwise (gloo also moves
    CUDA tensors, staged through the host). A no-op for one process and no
    address;
  * `rank()`, `world()`, `process_batch_slice`: this process's place;
  * `barrier_at_exit`: every rank waits for the others before it leaves (on
    a `tcp://` store rank 0 hosts the store, so the first rank to exit would
    take it down under the others);
  * `GracefulStop`: SIGTERM -> stop at the next epoch boundary, agreed
    across ranks by an all-reduce(MAX) of the flag, with the JAX latch.

`comm_ms`, when set to a dict, collects the host time of every collective
by kind ("grad", "bn", "loss", ...): each is then bracketed by device
synchronisations, so the time is the collective's alone, and the stalls
slow the step: time a step with it off. None (the default) adds nothing.
"""

from __future__ import annotations

import contextlib
import signal
import time
from typing import Iterator, Optional, Sequence

import torch
import torch.distributed as dist

comm_ms: Optional[dict] = None


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device: torch.device | str = "cuda") -> None:
    """torch.distributed.init_process_group; a no-op for one process and no
    address. `coordinator_address` is `host:port` (rank 0 hosts a TCP store
    there) or a `file://` path (torch's FileStore, on a file system every
    rank sees; the file must not exist yet). `backend` None means NCCL for
    a CUDA `device` and gloo for the CPU. A CUDA rank's current device
    becomes its card (mesh.rank_device)."""
    if num_processes in (None, 0, 1) and not coordinator_address:
        return
    if not coordinator_address:
        raise ValueError("a multi-process run needs a coordinator address (host:port or file://)")
    from tinyfaces_tpu_torch.parallel.mesh import rank_device

    world_size, rank_ = num_processes or 1, process_id or 0
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(rank_device(device, rank_))
    init = coordinator_address
    if "://" not in init:
        init = f"tcp://{init}"
    dist.init_process_group(backend, init_method=init, world_size=world_size, rank=rank_)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_batch_slice(global_batch_size: int) -> slice:
    """Which rows of the global batch this process loads."""
    per = global_batch_size // world()
    return slice(rank() * per, (rank() + 1) * per)


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(kind: str) -> Iterator[None]:
    """Adds the collective's host time to comm_ms[kind] when comm_ms is a
    dict (see the module docstring)."""
    if comm_ms is None:
        yield
        return
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    comm_ms[kind] = comm_ms.get(kind, 0.0) + 1000.0 * (time.perf_counter() - t0)


def barrier() -> None:
    if _nccl():
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def barrier_at_exit(name: str = "exit") -> None:
    """Wait for every rank, then leave the process group. No-op without
    one. `name` labels the barrier in an error."""
    if not dist.is_initialized():
        return
    try:
        barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed") from e
    dist.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; the gradient of every rank's x is the sum
    over ranks of the incoming gradients (each rank's loss depends on y)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        y = x.clone()
        with timed("bn"):
            dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        g = g.clone()
        with timed("bn"):
            dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable all-reduce SUM over the process group."""
    return _AllReduceSum.apply(x)


class _ReplayedAllReduceSum(torch.autograd.Function):
    """all_reduce_sum(x) whose result is already known: no collective in
    the forward pass, the same gradient as _AllReduceSum."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, result: torch.Tensor) -> torch.Tensor:
        return result.clone()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllReduceSum.backward(ctx, g), None


def replayed_all_reduce_sum(x: torch.Tensor, result: torch.Tensor) -> torch.Tensor:
    """`result`, an earlier all_reduce_sum(x), as a differentiable function
    of x: a recompute of the forward pass (models/resnet.py's `remat`)
    replays the gathered statistics instead of gathering them again."""
    return _ReplayedAllReduceSum.apply(x, result)


def _flat_in_place(tensors: Sequence[torch.Tensor], collective, kind: str) -> None:
    """Runs `collective` in place on one flat buffer per (device, dtype) of
    `tensors` and copies the result back: one call for a model's gradients,
    not one per tensor."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    with torch.no_grad():
        for group in groups.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            with timed(kind):
                collective(flat)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))


def all_reduce_tensors(tensors: Sequence[torch.Tensor], kind: str = "grad") -> None:
    """In-place all-reduce SUM of `tensors` over the process group."""
    _flat_in_place(tensors, dist.all_reduce, kind)


def broadcast_tensors(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """In-place broadcast of `tensors` from rank `src`."""
    _flat_in_place(tensors, lambda flat: dist.broadcast(flat, src), "broadcast")


class GracefulStop:
    """SIGTERM -> stop after the current epoch, agreed across processes.

    A scheduler may signal only some ranks. With a per-process flag the
    signalled rank would leave the epoch loop while the others enter the
    next epoch's collectives and wait for it forever; `agreed()` is a
    collective at the epoch boundary, so one rank's signal stops every rank
    at the same boundary. Use as a context manager: the previous handlers
    come back on exit. Signal handlers can only be installed from the main
    thread."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._previous = {s: signal.signal(s, self._handler) for s in signals}

    def _handler(self, signum, frame):
        print(f"signal {signum}: will checkpoint and stop after this epoch", flush=True)
        self._flag = True

    def requested(self) -> bool:
        """This process's own flag (no collective: safe mid-epoch)."""
        return self._flag

    def agreed(self) -> bool:
        """The stop decision at an epoch boundary. Every rank must call it
        at the same point: with more than one process it is a collective."""
        if world() == 1:
            return self._flag
        dev = torch.device("cuda", torch.cuda.current_device()) if _nccl() else torch.device("cpu")
        flag = torch.tensor([int(self._flag)], dtype=torch.int32, device=dev)
        with timed("stop"):
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        agreed = bool(flag.item())
        # Latch: once any rank stopped, every rank reports stop from here on.
        self._flag = self._flag or agreed
        return agreed

    def close(self) -> None:
        for s, previous in self._previous.items():
            signal.signal(s, previous)
        self._previous = {}

    def __enter__(self) -> "GracefulStop":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

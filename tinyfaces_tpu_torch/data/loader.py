"""Threaded prefetching batch loaders with pinned host buffers.

Port of tinyfaces_tpu/data/loader.py on the `rgb` wire, over any map-style
dataset whose items are train-sample dicts in the format
`WIDERFace.__getitem__` returns: image (H, W, 3) uint8, gt_boxes (G, 4)
float32, gt_valid (G,) bool, paste_box (4,) float32, flip bool.

Worker threads load samples while the device runs the previous step;
collated batches go through a bounded queue. The shuffle is a pure function
of (seed, epoch), the dataset's augmentation stream is rebased on the same
epoch (`set_epoch`), and the trailing partial batch is dropped. For a CUDA
device each batch is collated into pinned host memory and copied with
`non_blocking=True`, so the upload overlaps the running step.

`NativePrefetchLoader` runs the augmentation in the C++ engine
(data/native.py) on decoded pixels, seeded as the JAX package's native
loader is. Each loader records the consumer's wait on the queue per batch
(`wait_ms`): the host time a step waits for its input.

Only the `rgb` wire (uint8 pixels) and one process are ported: the JAX
loader's `pack` and `rank`/`world` have no counterpart here yet.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

_STOP = object()
_PREFETCH = 4  # collated batches waiting ahead of the consumer


def _collate(items: list[dict], pin: bool) -> dict:
    out = {}
    for k in items[0]:
        vals = [it[k] for it in items]
        arr = np.stack(vals) if np.ndim(vals[0]) else np.array(vals)
        t = torch.from_numpy(np.ascontiguousarray(arr))
        out[k] = t.pin_memory() if pin else t
    return out


class PrefetchLoader:
    """Iterable over device batches of a map-style train dataset."""

    def __init__(self, dataset, batch_size: int, device: torch.device | str = "cuda",
                 workers: int = 8, seed: int = 0, epoch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.workers = max(1, workers)
        self.seed = seed
        self.epoch = epoch
        self.wait_ms: list[float] = []  # consumer's wait per batch of the last epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size  # drop_last

    def order(self, epoch: int) -> np.ndarray:
        """Sample order of an epoch: a pure function of (seed, epoch)."""
        order = np.arange(len(self.dataset))
        np.random.default_rng(np.random.SeedSequence((self.seed, epoch))).shuffle(order)
        return order

    def _begin_epoch(self) -> np.ndarray:
        """Rebase the dataset's augmentation stream on this epoch and return
        its order, so two same-seed loaders give identical batches whatever
        the worker threads' schedule."""
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        order = self.order(self.epoch)
        self.epoch += 1
        return order

    def _host_batches(self, order: np.ndarray, load: Callable[[int], dict]) -> Iterator[dict]:
        nb = len(self)
        self.wait_ms = []
        if nb == 0:
            return
        pin = self.device.type == "cuda"
        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
                        q.put(_collate(list(pool.map(load, (int(i) for i in idxs))), pin))
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
                return
            q.put(_STOP)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                self.wait_ms.append(1000.0 * (time.perf_counter() - t0))
                yield item
        finally:
            stop.set()
            while producer.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def _device_batches(self, load: Callable[[int], dict]) -> Iterator[dict]:
        for host in self._host_batches(self._begin_epoch(), load):
            yield {k: v.to(self.device, non_blocking=True) for k, v in host.items()}

    def __iter__(self) -> Iterator[dict]:
        return self._device_batches(self.dataset.__getitem__)


class NativePrefetchLoader(PrefetchLoader):
    """PrefetchLoader whose worker threads decode a sample (`dataset._decode`)
    and augment it in the C++ engine, one call per sample (the call drops
    the GIL, so decode and augmentation of different samples overlap). The
    dataset must be a train `WIDERFace` (samples, cfg, _decode). Seeds
    follow the JAX package's native loader: a base drawn from
    SeedSequence((seed, epoch, 0xC0FFEE)), plus index * 0x9E3779B9."""

    def __iter__(self) -> Iterator[dict]:
        from tinyfaces_tpu_torch.data import native

        native.load()  # build or raise before any worker starts
        epoch = self.epoch
        cfg = self.dataset.cfg
        base_seed = int(np.random.default_rng(
            np.random.SeedSequence((self.seed, epoch, 0xC0FFEE))).integers(0, 2**62))

        def decode_and_augment(i: int) -> dict:
            return native.native_augment_sample(
                self.dataset._decode(i), self.dataset.samples[i].bboxes.astype(np.float32),
                cfg.input_size, cfg.neg_thresh, cfg.max_gt, seed=base_seed + i * 0x9E3779B9)

        return self._device_batches(decode_and_augment)

"""Threaded prefetching batch loader with pinned host buffers.

Port of tinyfaces_tpu/data/loader.py's PrefetchLoader for the `rgb` wire,
over any map-style dataset whose items are train-sample dicts in the format
`WIDERFace.__getitem__` returns: image (H, W, 3) uint8, gt_boxes (G, 4)
float32, gt_valid (G,) bool, paste_box (4,) float32, flip bool.

Worker threads load samples while the device runs the previous step;
collated batches go through a bounded queue. The shuffle is a pure function
of (seed, epoch) and the trailing partial batch is dropped. For a CUDA
device each batch is collated into pinned host memory and copied with
`non_blocking=True`, so the upload overlaps the running step.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

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

    def __init__(self, dataset, batch_size: int, device: torch.device | str = "cpu",
                 workers: int = 8, seed: int = 0, epoch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.workers = max(1, workers)
        self.seed = seed
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size  # drop_last

    def order(self, epoch: int) -> np.ndarray:
        """Sample order of an epoch: a pure function of (seed, epoch)."""
        order = np.arange(len(self.dataset))
        np.random.default_rng(np.random.SeedSequence((self.seed, epoch))).shuffle(order)
        return order

    def _host_batches(self, order: np.ndarray) -> Iterator[dict]:
        nb = len(self)
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
                        q.put(_collate(list(pool.map(lambda i: self.dataset[int(i)], idxs)), pin))
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
                return
            q.put(_STOP)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while producer.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def __iter__(self) -> Iterator[dict]:
        order = self.order(self.epoch)
        self.epoch += 1
        for host in self._host_batches(order):
            yield {k: v.to(self.device, non_blocking=True) for k, v in host.items()}

"""Threaded prefetching batch loaders with pinned host buffers.

Port of tinyfaces_tpu/data/loader.py, over any map-style dataset whose
items are train-sample dicts in the format `WIDERFace.__getitem__` returns:
image (H, W, 3) uint8, gt_boxes (G, 4) float32, gt_valid (G,) bool,
paste_box (4,) float32, flip bool. With `pack="jpegdct"` the items come
from `dataset.getitem_train_dct` instead: dct_wire (713,992,) uint8 and the
device augmentation's aug_scale and aug_off in place of the image
(data/dct_train.py). With `pack="yuv420"` the worker threads convert each
augmented canvas to planar YCbCr 4:2:0 (data/targets.rgb_to_yuv420, 1.5
B/px): image_y (H, W), image_u and image_v (H/2, W/2) uint8 in place of
the image; build_targets converts them back on the device.

Worker threads load samples while the device runs the previous step;
collated batches go through a bounded queue. The shuffle is a pure function
of (seed, epoch), the dataset's augmentation stream is rebased on the same
epoch (`set_epoch`), and the trailing partial batch is dropped. For a CUDA
device each batch is collated into pinned host memory and copied with
`non_blocking=True`, so the upload overlaps the running step.

`NativePrefetchLoader` runs the augmentation in the C++ engine
(data/native.py) on decoded pixels, seeded as the JAX package's native
loader is.

Spans (utils/profiling.py), when they record: on the consumer's thread
`loader.get` (the wait on the queue; `ready` the batches queued at the get,
`first` the epoch's first get, which waits out the thread pool's start) and
`loader.upload` (the copies' enqueue); on the producer thread
`loader.batch` (first sample submitted to collated and pinned), inside it
`loader.collate`, then `loader.put` (blocked on a full queue: the loader is
ahead); on the worker threads of `NativePrefetchLoader` `loader.decode` and
`loader.augment` per sample. `batch` ties a batch's production to the get
that consumed it.

`rank`/`world` feed one process of a multi-process run, as in the JAX
loader: `batch_size` stays the global batch, every rank computes the same
(seed, epoch) order and loads only its rows [rank*per, (rank+1)*per) of
each global batch (per = batch_size // world). The augmentation draws are
keyed by the sample index, so a rank's rows are augmented exactly as one
process augments them.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np
import torch

from tinyfaces_tpu_torch.utils.profiling import span

_STOP = object()
_PREFETCH = 4  # collated batches waiting ahead of the consumer
PACKS = ("rgb", "yuv420", "jpegdct")


def _pack_yuv(item: dict) -> dict:
    """A train sample with its RGB canvas replaced by planar YCbCr 4:2:0
    (1.5 B/px); build_targets converts it back on the device."""
    from tinyfaces_tpu_torch.data.targets import rgb_to_yuv420

    item = dict(item)
    y, u, v = rgb_to_yuv420(item.pop("image")[None])
    item["image_y"], item["image_u"], item["image_v"] = y[0], u[0], v[0]
    return item


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
                 workers: int = 8, seed: int = 0, epoch: int = 0, pack: str = "rgb",
                 rank: int = 0, world: int = 1):
        if world > 1 and batch_size % world:
            raise ValueError(f"batch_size {batch_size} not divisible by world {world}")
        if pack not in PACKS:
            raise ValueError(f"unknown pack mode {pack!r}; use one of {PACKS}")
        self.pack = pack
        self.dataset = dataset
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.workers = max(1, workers)
        self.seed = seed
        self.epoch = epoch
        self.rank, self.world = rank, world

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

    def _batch_indices(self, order: np.ndarray, b: int) -> np.ndarray:
        """Global batch b's sample indices, restricted to this rank's rows."""
        idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
        per = self.batch_size // self.world
        return idxs[self.rank * per:(self.rank + 1) * per] if self.world > 1 else idxs

    def _host_batches(self, order: np.ndarray, load: Callable[[int], dict]) -> Iterator[dict]:
        nb = len(self)
        if nb == 0:
            return
        pin = self.device.type == "cuda"
        q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.workers, thread_name_prefix="loader worker") as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        idxs = self._batch_indices(order, b)
                        with span("loader.batch", batch=b):
                            items = list(pool.map(load, (int(i) for i in idxs)))
                            with span("loader.collate", batch=b):
                                host = _collate(items, pin)
                        with span("loader.put", batch=b):
                            q.put(host)
            except BaseException as e:  # surface worker errors to the consumer
                q.put(e)
                return
            q.put(_STOP)

        producer = threading.Thread(target=produce, daemon=True, name="loader producer")
        producer.start()
        try:
            for b in range(nb):
                with span("loader.get", batch=b, ready=q.qsize, first=b == 0):
                    item = q.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
            item = q.get()  # the producer's last word: _STOP, or its error
            if isinstance(item, BaseException):
                raise item
        finally:
            stop.set()
            while producer.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass

    def _device_batches(self, load: Callable[[int], dict]) -> Iterator[dict]:
        if self.pack == "yuv420":
            pixels = load
            load = lambda i: _pack_yuv(pixels(i))  # noqa: E731
        for b, host in enumerate(self._host_batches(self._begin_epoch(), load)):
            with span("loader.upload", batch=b):
                batch = {k: v.to(self.device, non_blocking=True) for k, v in host.items()}
            yield batch

    def __iter__(self) -> Iterator[dict]:
        if self.pack == "jpegdct":
            # no host pixel decode: entropy decode (C++, GIL-free, cached
            # across epochs), coefficient crop and pack; the device augments
            return self._device_batches(self.dataset.getitem_train_dct)
        return self._device_batches(self.dataset.__getitem__)


class NativePrefetchLoader(PrefetchLoader):
    """PrefetchLoader whose worker threads decode a sample (`dataset._decode`)
    and augment it in the C++ engine, one call per sample (the call drops
    the GIL, so decode and augmentation of different samples overlap). The
    dataset must be a train `WIDERFace` (samples, cfg, _decode). Seeds
    follow the JAX package's native loader: a base drawn from
    SeedSequence((seed, epoch, 0xC0FFEE)), plus index * 0x9E3779B9. With
    pack="jpegdct" there are no pixels for the engine: the Python path
    above runs, as in the JAX package."""

    def __iter__(self) -> Iterator[dict]:
        from tinyfaces_tpu_torch.data import native

        if self.pack == "jpegdct":
            return super().__iter__()

        native.load()  # build or raise before any worker starts
        epoch = self.epoch
        cfg = self.dataset.cfg
        base_seed = int(np.random.default_rng(
            np.random.SeedSequence((self.seed, epoch, 0xC0FFEE))).integers(0, 2**62))

        def decode_and_augment(i: int) -> dict:
            with span("loader.decode", index=i):
                image = self.dataset._decode(i)
            with span("loader.augment", index=i):
                return native.native_augment_sample(
                    image, self.dataset.samples[i].bboxes.astype(np.float32),
                    cfg.input_size, cfg.neg_thresh, cfg.max_gt, seed=base_seed + i * 0x9E3779B9)

        return self._device_batches(decode_and_augment)

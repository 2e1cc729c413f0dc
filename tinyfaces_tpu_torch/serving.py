"""Dynamic-batching detection service over PyramidDetector.

Port of tinyfaces_tpu/serving.py on every wire of PyramidDetector:
  * callers submit (H, W, 3) uint8 images — on the JPEG wires (`jpegdct`,
    `jpegdct4`) also JPEG bytes or a DCTImage — from any thread and get a Future that resolves to
    the (N, 5) detections;
  * a dispatcher thread groups pending requests into device batches —
    same-bucket images together, at most `max_batch`, waiting at most
    `max_delay_ms` for more — padded to the next power of two so the set of
    batch shapes stays small;
  * batches are queued with detect_batch_async, so packing and upload of the
    next batch overlap device compute of the current one.

On a GPU each padded batch shape replays its own captured pyramid
(evaluation.PyramidDetector): the ladder bounds a service run to
log2(max_batch) + 1 graphs per canvas bucket (5 at the default 16: batch
1, 2, 4, 8 and 16), each captured at its second batch (its first runs
eagerly), all in the replica's one memory pool.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from tinyfaces_tpu_torch.data.jpegdct import as_wire_input, input_dims
from tinyfaces_tpu_torch.evaluation import PyramidDetector, _round_up


class DetectionService:
    def __init__(
        self,
        detector: PyramidDetector,
        max_batch: int = 16,
        max_delay_ms: float = 25.0,
        scales: Optional[Sequence[float]] = None,
        prob_thresh: Optional[float] = None,
        nms_thresh: Optional[float] = None,
    ):
        self.detector = detector
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.scales = scales
        self.prob_thresh = prob_thresh
        self.nms_thresh = nms_thresh

        self._queue: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._dispatcher = threading.Thread(target=self._run, daemon=True)
        self._dispatcher.start()

    def submit(self, image) -> Future:
        """Enqueue one image; resolves to (N, 5) detections. Takes (H, W, 3)
        uint8 arrays; on the JPEG wires also JPEG bytes or a DCTImage.
        Baseline 4:2:0 and grayscale JPEG bytes stay raw (a header-only
        probe here) and are entropy-decoded and packed in one C++ pass at
        dispatch; other inputs are entropy-decoded (or transcoded) on the
        caller's thread."""
        if self.detector.transfer.startswith("jpegdct"):
            image = as_wire_input(image)
        fut: Future = Future()
        self._queue.put((image, fut))
        return fut

    def detect(self, image) -> np.ndarray:
        return self.submit(image).result()

    def close(self) -> None:
        self._stop.set()
        self._dispatcher.join(timeout=5)

    # -- dispatcher ----------------------------------------------------------

    def _drain_group(self) -> list:
        """Collect up to max_batch same-bucket requests within max_delay."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        group = [first]
        bucket = self._bucket(first[0])
        t0 = time.monotonic()
        leftovers = []
        while len(group) < self.max_batch:
            remaining = self.max_delay - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if self._bucket(item[0]) == bucket:
                group.append(item)
            else:
                leftovers.append(item)
        for item in leftovers:  # different bucket: next round
            self._queue.put(item)
        return group

    @staticmethod
    def _bucket(image) -> tuple[int, int]:
        h, w = input_dims(image)
        return (_round_up(h), _round_up(w))

    def _resolve(self, entry) -> None:
        submitted, group = entry
        try:
            results = self.detector._fetch(submitted.result())
        except Exception as e:  # the dispatcher keeps serving; each caller gets the error
            for _, fut in group:
                fut.set_exception(e)
            return
        for (_, fut), dets in zip(group, results):
            fut.set_result(dets)

    @staticmethod
    def _pad_batch(images: list) -> list:
        """Pad a group to the next power of two by repeating the last image
        (surplus outputs discarded), bounding the batch shapes to
        log2(max_batch) + 1."""
        n = 1
        while n < len(images):
            n *= 2
        return images + [images[-1]] * (n - len(images))

    def _run(self) -> None:
        # Two host stages, as in the evaluation sweep: pack and
        # upload+dispatch (one worker keeps the dispatch order).
        pack_pool = ThreadPoolExecutor(1)
        submit_pool = ThreadPoolExecutor(1)
        pending: list = []  # in-flight [(submitted_future, group)], depth <= 2
        while not self._stop.is_set() or not self._queue.empty() or pending:
            group = self._drain_group()
            if group:
                packed = pack_pool.submit(self.detector.pack_inputs,
                                          self._pad_batch([im for im, _ in group]))
                submitted = submit_pool.submit(
                    lambda p=packed: self.detector.detect_batch_async(
                        p.result(), self.prob_thresh, self.nms_thresh, self.scales))
                pending.append((submitted, group))
            # pipeline depth 2: resolve the oldest batch when a newer one is
            # in flight, or when there is no new work to queue
            if pending and (len(pending) >= 2 or not group):
                self._resolve(pending.pop(0))
        pack_pool.shutdown(wait=False)
        submit_pool.shutdown(wait=False)

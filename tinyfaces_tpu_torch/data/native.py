"""ctypes bindings of the C++ augmentation engine (csrc/tinyfaces_native.cpp).

`native_augment_sample` and `native_augment_batch` produce the same train
sample dicts as wider_face.augment_sample, with the whole augmentation
chain in C++ outside the GIL; their outputs equal the JAX package's engine
(tinyfaces_tpu/data/native.py) bit for bit from the same seeds. Every
sample's pre-cap GT count goes to data/overflow.py.

The library is built at first use (utils/cuda_build.load_host_library).
There is no fallback: a failed build, a failed load or a wrong ABI version
raises, and the caller names the engine it wants (Trainer(augment=...)).

`counters` holds the samples augmented here and the wall seconds of the
C++ calls, summed over the Python threads that made them, for callers that
show which engine ran and what it cost.
"""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Sequence

import numpy as np

from tinyfaces_tpu_torch.data import overflow
from tinyfaces_tpu_torch.utils.cuda_build import load_host_library

_ABI_VERSION = 7
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
counters = {"samples": 0, "seconds": 0.0}


def load() -> ctypes.CDLL:
    """Build (if needed), load and check the engine; raises on any failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_host_library("tinyfaces_native")
        lib.tf_version.restype = ctypes.c_int
        if lib.tf_version() != _ABI_VERSION:
            raise RuntimeError(f"tinyfaces_native ABI {lib.tf_version()}, bindings expect {_ABI_VERSION}")
        lib.tf_augment_sample.restype = None
        lib.tf_augment_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # img, h, w
            ctypes.c_void_p, ctypes.c_int,  # boxes, n_boxes
            ctypes.c_int, ctypes.c_int,  # input_h, input_w
            ctypes.c_float,  # neg_thresh
            ctypes.c_int,  # max_gt
            ctypes.c_uint64,  # seed
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs
        ]
        lib.tf_augment_batch.restype = None
        lib.tf_augment_batch.argtypes = [
            ctypes.c_int,  # batch
            ctypes.POINTER(ctypes.c_void_p),  # imgs
            ctypes.POINTER(ctypes.c_int),  # hs
            ctypes.POINTER(ctypes.c_int),  # ws
            ctypes.POINTER(ctypes.c_void_p),  # boxes
            ctypes.POINTER(ctypes.c_int),  # n_boxes
            ctypes.c_int, ctypes.c_int,  # input_h, input_w
            ctypes.c_float,  # neg_thresh
            ctypes.c_int,  # max_gt
            ctypes.c_uint64,  # seed
            ctypes.c_int,  # n_threads
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # outputs
        ]
        _lib = lib
        return lib


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _outputs(b: int, input_size: tuple[int, int], max_gt: int) -> dict:
    ih, iw = input_size
    return {"image": np.empty((b, ih, iw, 3), np.uint8),
            "gt_boxes": np.empty((b, max_gt, 4), np.float32),
            "gt_valid": np.empty((b, max_gt), np.uint8),
            "paste_box": np.empty((b, 4), np.float32),
            "flip": np.empty((b,), np.uint8),
            "n_kept": np.empty((b,), np.int32)}


def _finish(out: dict, max_gt: int, seconds: float) -> dict:
    for n in out.pop("n_kept"):
        overflow.record(int(n), max_gt)
    with _lock:
        counters["samples"] += len(out["flip"])
        counters["seconds"] += seconds
    out["gt_valid"] = out["gt_valid"].astype(bool)
    out["flip"] = out["flip"].astype(bool)
    return out


def native_augment_sample(
    image: np.ndarray,  # (H, W, 3) uint8
    boxes: np.ndarray,  # (N, 4) float32
    input_size: tuple[int, int],
    neg_thresh: float,
    max_gt: int,
    seed: int,
) -> dict:
    """Augment ONE sample in C++ (the GIL is released for the call, so the
    loader's worker threads decode and augment in parallel)."""
    lib = load()
    image = np.ascontiguousarray(image, np.uint8)
    boxes = np.ascontiguousarray(boxes, np.float32).reshape(-1, 4)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3) uint8, got {image.shape}")
    out = _outputs(1, input_size, max_gt)
    t0 = time.perf_counter()
    lib.tf_augment_sample(
        _ptr(image), image.shape[0], image.shape[1], _ptr(boxes), boxes.shape[0],
        input_size[0], input_size[1], ctypes.c_float(neg_thresh), max_gt, ctypes.c_uint64(seed),
        _ptr(out["image"]), _ptr(out["gt_boxes"]), _ptr(out["gt_valid"]),
        _ptr(out["paste_box"]), _ptr(out["flip"]), _ptr(out["n_kept"]),
    )
    out = _finish(out, max_gt, time.perf_counter() - t0)
    return {"image": out["image"][0], "gt_boxes": out["gt_boxes"][0],
            "gt_valid": out["gt_valid"][0], "paste_box": out["paste_box"][0],
            "flip": bool(out["flip"][0])}


def native_augment_batch(
    images: Sequence[np.ndarray],  # list of (H, W, 3) uint8
    boxes: Sequence[np.ndarray],  # list of (N, 4) float32 corner boxes
    input_size: tuple[int, int],
    neg_thresh: float,
    max_gt: int,
    seed: int,
    n_threads: int = 8,
) -> dict:
    """Augment a batch in C++ on `n_threads` threads; sample i is seeded
    with seed + i * 0x9E3779B97F4A7C15. Returns the training batch dict."""
    lib = load()
    b = len(images)
    images = [np.ascontiguousarray(im, np.uint8) for im in images]
    boxes = [np.ascontiguousarray(bx, np.float32).reshape(-1, 4) for bx in boxes]
    if any(im.ndim != 3 or im.shape[2] != 3 for im in images) or len(boxes) != b:
        raise ValueError("images must be (H, W, 3) uint8, one box array each")
    img_ptrs = (ctypes.c_void_p * b)(*[im.ctypes.data for im in images])
    box_ptrs = (ctypes.c_void_p * b)(*[bx.ctypes.data for bx in boxes])
    hs = (ctypes.c_int * b)(*[im.shape[0] for im in images])
    ws = (ctypes.c_int * b)(*[im.shape[1] for im in images])
    nb = (ctypes.c_int * b)(*[bx.shape[0] for bx in boxes])
    out = _outputs(b, input_size, max_gt)
    t0 = time.perf_counter()
    lib.tf_augment_batch(
        b, img_ptrs, hs, ws, box_ptrs, nb, input_size[0], input_size[1],
        ctypes.c_float(neg_thresh), max_gt, ctypes.c_uint64(seed), n_threads,
        _ptr(out["image"]), _ptr(out["gt_boxes"]), _ptr(out["gt_valid"]),
        _ptr(out["paste_box"]), _ptr(out["flip"]), _ptr(out["n_kept"]),
    )
    return _finish(out, max_gt, time.perf_counter() - t0)

"""Host half of the `jpegdct` train wire: ship the entropy-decoded DCT
coefficients of just the augmentation's source region; the device decodes
them (dequant, IDCT, chroma upsample) and applies the resize, crop, paste
and flip (data/targets.device_augment_dct).

Port of tinyfaces_tpu/data/dct_train.py. The host keeps only the
sequential JPEG entropy decode (C++ csrc/jpeg_dct.cpp, once per image per
process thanks to `CoefCache`) and a block-aligned coefficient crop and
pack; every pixel operation runs on the device inside the train step.

Geometry is bit-identical to the rgb path: both take
wider_face.augment_draws, so GT boxes, paste_box and flip match exactly.
Pixels differ only by (a) the wire's lossy coefficient budget, (b) float
against uint8-quantized intermediates and (c) edge clamping of the device
resize filters at image borders (1-px effects); the filters themselves
replicate PIL BILINEAR's triangle kernels for exact x0.5 / x2 factors.

Region layout: a sample's crop needs source pixels [a0, a0 + extent) with
extent <= 2*input + filter margin (the x0.5 branch: 2*500 + margins). One
static region TRAIN_REGION = 1024 (a multiple of 16: a 4:2:0 chroma block
covers 16 luma px) covers every branch; the anchor a0 is 16-aligned so the
luma and chroma grids crop cleanly. The per-scale slice offset within the
(half-resolution, full or upsampled) region rides in aug_off; the bounds
are in region_anchor's docstring.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from tinyfaces_tpu_torch.config import DetectorConfig
from tinyfaces_tpu_torch.data.jpegdct import DCTImage, pack_dct_batch, parse_jpeg_dct, wire_layout
from tinyfaces_tpu_torch.data.wider_face import AugDraws, augment_draws

# Static source-region canvas (px, square, multiple of 16). 1024 covers the
# worst case: the x0.5 scale needs 2*500 source px + 2 px filter margin +
# 15 px alignment slack = 1017.
TRAIN_REGION = 1024


def wire_total_bytes(region: int = TRAIN_REGION) -> int:
    return wire_layout(region, region)["__total__"]


def upsample_src(input_size: int) -> int:
    """Static side of the x2 branch's source slice: output rows [cy, cy+ih)
    of the 2x-upsampled image need source rows up to
    floor((cy + ih - 1)/2) + 1 - a0y <= aug_off/2 + ih/2 + 2 where
    aug_off <= 34 (region_anchor), so ih/2 + 19, rounded up to 16."""
    need = input_size // 2 + 19
    return ((need + 15) // 16) * 16


def region_anchor(d: AugDraws) -> tuple[int, int, int, int]:
    """(a0y, a0x, off_y, off_x): the 16-aligned source-region origin and the
    per-scale slice offset the device applies.

    scale 1 : a0 = 16*floor(c/16);              off = c - a0       in [0, 16)
    scale .5: a0 = max(0, 16*floor((2c-2)/16)); off = c - a0/2     in [0, 9)
              (a0 even => off integer; a0 <= 2c-2 gives the 1-row top
               margin the 4-tap downscale filter reads, except at c=0
               where PIL clamps at the true image edge and a0=0 clamps
               identically)
    scale 2 : a0 = max(0, 16*floor((c/2-1)/16)); off = c - 2*a0    in [0, 35)
              (2x-upsampling the region reproduces resized rows
               [2*a0, ...); the 0.25-weight tap at c=0 clamps at the
               image edge on both paths)
    """
    cy, cx = d.crop_y1, d.crop_x1
    if d.scale_id == 1:
        a0y, a0x = (cy // 16) * 16, (cx // 16) * 16
        return a0y, a0x, cy - a0y, cx - a0x
    if d.scale_id == 0:
        a0y = max(0, ((2 * cy - 2) // 16) * 16)
        a0x = max(0, ((2 * cx - 2) // 16) * 16)
        return a0y, a0x, cy - a0y // 2, cx - a0x // 2
    a0y = max(0, ((cy // 2 - 1) // 16) * 16)
    a0x = max(0, ((cx // 2 - 1) // 16) * 16)
    return a0y, a0x, cy - 2 * a0y, cx - 2 * a0x


def crop_coef_region(dct: DCTImage, a0y: int, a0x: int, region: int = TRAIN_REGION) -> DCTImage:
    """Block-aligned coefficient crop: luma blocks [a0/8, a0/8 + region/8),
    chroma [a0/16, ...). Blocks past the image are absent from the slices;
    pack_dct_batch fills them with the MEAN_PIXEL canvas value, as the host
    path's canvas prefill."""
    nb, nbc = region // 8, region // 16
    by, bx = a0y // 8, a0x // 8
    cy, cx = a0y // 16, a0x // 16
    return DCTImage(
        h=max(0, min(region, dct.h - a0y)),
        w=max(0, min(region, dct.w - a0x)),
        y=dct.y[by:by + nb, bx:bx + nb],
        cb=None if dct.cb is None else dct.cb[cy:cy + nbc, cx:cx + nbc],
        cr=None if dct.cr is None else dct.cr[cy:cy + nbc, cx:cx + nbc],
        qy=dct.qy, qc=dct.qc,
    )


def train_item_dct(dct: DCTImage, bboxes: np.ndarray, cfg: DetectorConfig,
                   rng: np.random.Generator) -> dict:
    """One training sample on the jpegdct wire: the rgb path's keys, with
    the wire and the device augmentation's parameters in place of pixels."""
    d, gt, gt_valid, paste_box = augment_draws((dct.h, dct.w), bboxes, cfg, rng)
    a0y, a0x, offy, offx = region_anchor(d)
    wire = pack_dct_batch([crop_coef_region(dct, a0y, a0x)], TRAIN_REGION, TRAIN_REGION)
    return {
        "dct_wire": wire["_wire"][0],
        "gt_boxes": gt,
        "gt_valid": gt_valid,
        "paste_box": paste_box,
        "flip": d.flip,
        "aug_scale": np.int32(d.scale_id),
        "aug_off": np.array([offy, offx], np.int32),
    }


class CoefCache:
    """Entropy-decoded coefficients per image: the decode is the one
    sequential host cost of this wire and a pure function of the file, so
    it runs once per process and every later epoch reuses it. Capped by
    TINYFACES_DCT_CACHE_GB (default 32; the 12.9k-image WIDER train tree
    holds ~28 GB of int16 coefficients). Thread-safe for the loader's
    workers."""

    def __init__(self) -> None:
        self.cap = int(float(os.environ.get("TINYFACES_DCT_CACHE_GB", "32")) * (1 << 30))
        self._store: dict = {}
        self._bytes = 0
        self._lock = threading.Lock()

    def get(self, key, loader) -> DCTImage:
        with self._lock:
            hit = self._store.get(key)
        if hit is not None:
            return hit
        dct = loader()
        nbytes = dct.y.nbytes + sum(p.nbytes for p in (dct.cb, dct.cr) if p is not None)
        with self._lock:
            if self._bytes + nbytes <= self.cap and key not in self._store:
                self._store[key] = dct
                self._bytes += nbytes
        return dct


def decode_dct(data: bytes) -> DCTImage:
    """Raw JPEG bytes -> coefficient planes (the C++ entropy decoder, with
    PIL's transcode for other streams where PIL is installed)."""
    return parse_jpeg_dct(data)

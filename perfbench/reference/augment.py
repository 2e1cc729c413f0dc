"""The train loader's input, redone from the files the harness wrote: the
WIDER annotation, the epoch's order, PIL's decode of each JPEG file, and
the reference's train augmentation (`wider_face.py`, `processor.py`) with
the draws the C++ engine makes.

* Annotation (WIDER `bbx_gt`): per image its path, a count, then one row
  `x y w h` plus six attributes a face (absolute values); rows with a zero
  width or height are dropped; corners are (x, y, x + w - 1, y + h - 1).
* Order: the epoch's sample indices shuffled by numpy's generator seeded
  with (seed, epoch); batch k holds rows k * B to (k + 1) * B.
* Draws: sample i of an epoch is seeded with base + i * 0x9E3779B9 (mod
  2**64), base drawn from SeedSequence((seed, epoch, 0xC0FFEE)), into a
  64-bit Mersenne twister (`MT19937_64`, the C++ standard's); a real in
  [0, 1) is one 64-bit draw over 2**64, an integer in [lo, hi] Lemire's
  multiply-and-reject over one 64-bit draw (libstdc++'s distributions).
* Augmentation, in draw order: a real r picks the scale (x0.5 below 1/3,
  where both sides are at least 2; x2 above 2/3; else x1): x0.5 is the
  rounded mean of each 2 x 2 block (edge rows and columns repeated), x2
  the bilinear phases 1/4 and 3/4 in integers, rounded (the edge row and
  column repeated); the crop origin (x, then y) within the scaled image;
  the paste origin (x, then y) on the input-sized canvas of the mean pixel
  (123, 116, 103); each scaled box kept if, moved by the crop and paste
  and clamped to the canvas, it has a positive extent and its part inside
  the crop covers at least neg_thresh of it (IoU with the +1 convention);
  a real over 0.5 mirrors canvas and boxes (x -> W - x + 1, the
  reference's MATLAB mirror); the first max_gt boxes are kept. Box
  arithmetic is float32 in the engine's order.

`aug_diff` counts the values of the loader's batches (pixels, boxes, their
valid flags, the paste box, the flip) that differ from these: an exact
comparison, limit 0.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

M64 = (1 << 64) - 1
MEAN_PIXEL = np.array([123, 116, 103], np.uint8)
F32 = np.float32


class MT19937_64:
    """The C++ standard's std::mt19937_64."""

    def __init__(self, seed: int):
        mt = [seed & M64]
        for i in range(1, 312):
            mt.append((6364136223846793005 * (mt[-1] ^ (mt[-1] >> 62)) + i) & M64)
        self.mt, self.i = mt, 312

    def _twist(self) -> None:
        mt = self.mt
        for i in range(312):
            x = (mt[i] & 0xFFFFFFFF80000000) | (mt[(i + 1) % 312] & 0x7FFFFFFF)
            xa = x >> 1
            if x & 1:
                xa ^= 0xB5026F5AA96619E9
            mt[i] = mt[(i + 156) % 312] ^ xa
        self.i = 0

    def __call__(self) -> int:
        if self.i >= 312:
            self._twist()
        y = self.mt[self.i]
        self.i += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & M64

    def uniform(self) -> float:
        r = float(self()) / 2.0 ** 64
        return math.nextafter(1.0, 0.0) if r >= 1.0 else r

    def randint(self, lo: int, hi: int) -> int:
        span = hi - lo + 1
        prod = self() * span
        if prod & M64 < span:
            threshold = ((1 << 64) - span) % span
            while prod & M64 < threshold:
                prod = self() * span
        return lo + (prod >> 64)


def parse_annotations(path: Path) -> list:
    """[(relative image path, (n, 4) float64 corner boxes)] of a WIDER
    bbx_gt file."""
    lines = Path(path).read_text().splitlines()
    out, i = [], 0
    while i < len(lines):
        name, count = lines[i].strip(), int(lines[i + 1])
        i += 2
        rows = np.array([[abs(float(v)) for v in lines[i + k].split()[:4]] for k in range(count)],
                        np.float64).reshape(-1, 4)
        i += max(count, 1)  # an image with no face has one placeholder row
        rows = rows[(rows[:, 2] != 0) & (rows[:, 3] != 0)]
        out.append((name, np.stack([rows[:, 0], rows[:, 1], rows[:, 0] + rows[:, 2] - 1,
                                    rows[:, 1] + rows[:, 3] - 1], 1)))
    return out


def epoch_order(seed: int, epoch: int, n: int) -> np.ndarray:
    order = np.arange(n)
    np.random.default_rng(np.random.SeedSequence((seed, epoch))).shuffle(order)
    return order


def sample_seed(seed: int, epoch: int, index: int) -> int:
    base = int(np.random.default_rng(np.random.SeedSequence((seed, epoch, 0xC0FFEE))).integers(0, 2**62))
    return (base + index * 0x9E3779B9) & M64


def decode(path: Path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _half(src: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    sh, sw = src.shape[:2]
    a = src.astype(np.int32)
    r0, r1 = a[np.minimum(2 * rows, sh - 1)], a[np.minimum(2 * rows + 1, sh - 1)]
    c0, c1 = np.minimum(2 * cols, sw - 1), np.minimum(2 * cols + 1, sw - 1)
    return ((r0[:, c0] + r0[:, c1] + r1[:, c0] + r1[:, c1] + 2) >> 2).astype(np.uint8)


def _double_taps(idx: np.ndarray, n: int) -> tuple:
    """(first tap, second tap, weight of the second in quarters)."""
    i0 = np.clip((idx - 1) // 2, 0, n - 1)  # floor((i + 0.5) / 2 - 0.5), clamped
    w = np.where(idx % 2 == 1, 1, 3)
    i1 = np.minimum(i0 + 1, n - 1)
    edge = idx == 0  # the position before the first sample: the edge repeated
    return i0, np.where(edge, i0, i1), np.where(edge, 0, w)


def _double(src: np.ndarray, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    sh, sw = src.shape[:2]
    y0, y1, wy = _double_taps(rows, sh)
    x0, x1, wx = _double_taps(cols, sw)
    a = src.astype(np.int32)
    wx = wx[None, :, None]

    def horiz(r):
        return a[r][:, x0] * (4 - wx) + a[r][:, x1] * wx

    wy = wy[:, None, None]
    return ((horiz(y0) * (4 - wy) + horiz(y1) * wy + 8) >> 4).astype(np.uint8)


def _rect_overlap(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU (+1 convention) of float32 (n, 4) boxes a and b, as the engine
    computes 1 - rect_dist."""
    one = F32(1)
    ai = (a[:, 2] - a[:, 0] + one) * (a[:, 3] - a[:, 1] + one)
    aj = (b[:, 2] - b[:, 0] + one) * (b[:, 3] - b[:, 1] + one)
    x1, y1 = np.maximum(a[:, 0], b[:, 0]), np.maximum(a[:, 1], b[:, 1])
    x2, y2 = np.minimum(a[:, 2], b[:, 2]), np.minimum(a[:, 3], b[:, 3])
    inter = np.where((x2 > x1) & (y2 > y1), (x2 - x1 + one) * (y2 - y1 + one), F32(0))
    denom = ai + aj - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom != 0, inter / np.where(denom != 0, denom, one), F32(0))
    iou = np.where(np.isfinite(iou), iou, F32(0))
    return one - np.clip(one - iou, F32(0), one)


def augment(img: np.ndarray, boxes: np.ndarray, input_hw, neg_thresh: float, max_gt: int,
            seed: int) -> dict:
    """One train sample: canvas (H, W, 3) uint8, gt_boxes (max_gt, 4)
    float32, gt_valid (max_gt,) bool, paste_box (4,) float32, flip bool."""
    ih, iw = input_hw
    g = MT19937_64(seed)
    sh, sw = img.shape[:2]
    h, w, scale, resize = sh, sw, F32(1), None
    r = g.uniform()
    if r < 1.0 / 3.0 and min(sh, sw) >= 2:
        h, w, scale, resize = sh // 2, sw // 2, F32(0.5), _half
    elif r > 2.0 / 3.0:
        h, w, scale, resize = sh * 2, sw * 2, F32(2), _double
    cx1 = g.randint(0, max(0, w - iw))
    cy1 = g.randint(0, max(0, h - ih))
    cx2, cy2 = min(w, cx1 + iw), min(h, cy1 + ih)
    ch, cw = cy2 - cy1, cx2 - cx1
    px = g.randint(0, iw - cw)
    py = g.randint(0, ih - ch)
    rows, cols = np.arange(cy1, cy2), np.arange(cx1, cx2)
    crop = img[cy1:cy2, cx1:cx2] if resize is None else resize(img, rows, cols)
    canvas = np.empty((ih, iw, 3), np.uint8)
    canvas[:] = MEAN_PIXEL
    canvas[py:py + ch, px:px + cw] = crop

    orig = boxes.astype(F32).reshape(-1, 4) * scale
    clip = np.stack([np.maximum(orig[:, 0], F32(cx1)), np.maximum(orig[:, 1], F32(cy1)),
                     np.minimum(orig[:, 2], F32(cx2)), np.minimum(orig[:, 3], F32(cy2))], 1)
    overlap = _rect_overlap(clip, orig)
    moved = np.stack([orig[:, 0] - F32(cx1) + F32(px), orig[:, 1] - F32(cy1) + F32(py),
                      orig[:, 2] - F32(cx1) + F32(px), orig[:, 3] - F32(cy1) + F32(py)], 1)
    moved = np.stack([np.clip(moved[:, 0], F32(0), F32(iw)), np.clip(moved[:, 1], F32(0), F32(ih)),
                      np.clip(moved[:, 2], F32(1), F32(iw)), np.clip(moved[:, 3], F32(1), F32(ih))], 1)
    keep = (moved[:, 2] > moved[:, 0]) & (moved[:, 3] > moved[:, 1]) & (overlap >= F32(neg_thresh))
    kept = moved[keep]
    flip = g.uniform() > 0.5
    if flip:
        canvas = canvas[:, ::-1].copy()
        kept = np.stack([F32(iw) - kept[:, 2] + F32(1), kept[:, 1],
                         F32(iw) - kept[:, 0] + F32(1), kept[:, 3]], 1).reshape(-1, 4)
    n = min(len(kept), max_gt)
    gt = np.zeros((max_gt, 4), F32)
    gt[:n] = kept[:n]
    valid = np.zeros(max_gt, bool)
    valid[:n] = True
    return {"image": canvas, "gt_boxes": gt, "gt_valid": valid,
            "paste_box": np.array([px, py, px + cw, py + ch], F32), "flip": flip}


def batches(root: Path, annotation: Path, seed: int, batch: int, steps: int, input_hw,
            neg_thresh: float, max_gt: int, epoch: int = 0) -> list:
    """The first `steps` batches of the epoch, each a dict of CPU tensors."""
    samples = parse_annotations(annotation)
    order = epoch_order(seed, epoch, len(samples))
    images = Path(root) / "WIDER_train" / "images"
    out = []
    for k in range(steps):
        items = []
        for i in order[k * batch:(k + 1) * batch].tolist():
            name, boxes = samples[i]
            items.append(augment(decode(images / name), boxes, input_hw, neg_thresh, max_gt,
                                 sample_seed(seed, epoch, i)))
        out.append({key: torch.from_numpy(np.stack([np.asarray(it[key]) for it in items]))
                    for key in items[0]})
    return out


def aug_diff(program: list, reference: list) -> int:
    """Values of the program's batches that differ from the reference's:
    pixels, valid flags, paste boxes and flips, and the corners of every
    box that either side marks valid."""
    bad = 0
    for p, r in zip(program, reference, strict=True):
        p = {k: v.detach().cpu() for k, v in p.items()}
        bad += int((p["image"] != r["image"]).sum())
        bad += int((p["gt_valid"].bool() != r["gt_valid"]).sum())
        bad += int((p["paste_box"].float() != r["paste_box"]).sum())
        bad += int((p["flip"].bool() != r["flip"]).sum())
        either = (p["gt_valid"].bool() | r["gt_valid"])[..., None]
        bad += int(((p["gt_boxes"].float() != r["gt_boxes"]) & either).sum())
    return bad

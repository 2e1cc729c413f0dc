"""WIDER Face dataset: annotation parsing and host-side augmentation.

Port of tinyfaces_tpu/data/wider_face.py. Annotation format (reference
wider_face.py:65-121): an image path line, a count line, then `x y w h blur
expression illumination invalid occlusion pose` rows; all fields abs()'d,
zero-w/h boxes dropped, (x, y, w, h) -> (x1, y1, x2, y2) with the -1 MATLAB
convention; a count of 0 is followed by one placeholder row. The test split
is a bare file list.

Training (reference wider_face.py:133-165, processor.py:41-112): random
x0.5 / x1 / x2 resize, a random 500x500 crop pasted at a random offset onto
an ImageNet-mean canvas, overlap-based GT filtering, horizontal flip, and
GT padding to `max_gt` with the overflow counted (data/overflow.py). The
draws and the box math are those of the JAX package, bit for bit, from the
same numpy generator; the C++ engine (data/native.py) does the same chain
with its own stream. Each train sample is a dict:
  image     (H, W, 3) uint8
  gt_boxes  (max_gt, 4) float32, zero-padded
  gt_valid  (max_gt,) bool
  paste_box (4,) float32, where the crop landed (for the border mask)
  flip      bool, whether the sample was mirrored

Pixels are decoded by one method, `WIDERFace._decode`, so that a caller can
hand in decoded arrays; Pillow is imported only there and in the x0.5/x2
resize of the Python augmentation.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from tinyfaces_tpu_torch.config import IMAGENET_MEAN, DetectorConfig
from tinyfaces_tpu_torch.data import overflow

MEAN_PIXEL = tuple(int(m * 255) for m in IMAGENET_MEAN)  # (123, 116, 103)


@dataclasses.dataclass
class WiderSample:
    img_path: str
    bboxes: np.ndarray  # (N, 4) x1, y1, x2, y2 (MATLAB 1-indexed convention)
    attrs: Optional[dict] = None  # blur/expression/illumination/invalid/occlusion/pose


def parse_wider_annotations(path: str | Path, split: str = "train") -> List[WiderSample]:
    """Parse a WIDER bbx_gt annotation file (or test filelist)."""
    lines = Path(path).read_text().splitlines()

    if split == "test":
        return [WiderSample(l.strip(), np.zeros((0, 4), np.float64)) for l in lines if l.strip()]

    samples: List[WiderSample] = []
    i = 0
    while i < len(lines):
        img_path = lines[i].strip()
        i += 1
        count = int(lines[i].strip())
        i += 1

        rows = np.zeros((count, 10), np.float64)
        if count == 0:
            i += 1  # placeholder row
        else:
            for b in range(count):
                rows[b] = [abs(float(v)) for v in lines[i].split()]
                i += 1

        # Drop degenerate boxes, convert to corner form with -1 (MATLAB).
        rows = rows[(rows[:, 2] != 0) & (rows[:, 3] != 0)]
        boxes = rows[:, :4].copy()
        boxes[:, 2] = boxes[:, 0] + boxes[:, 2] - 1
        boxes[:, 3] = boxes[:, 1] + boxes[:, 3] - 1

        attrs = {
            "blur": rows[:, 4],
            "expression": rows[:, 5],
            "illumination": rows[:, 6],
            "invalid": rows[:, 7],
            "occlusion": rows[:, 8],
            "pose": rows[:, 9],
        }
        samples.append(WiderSample(img_path, boxes, attrs))
    return samples


def _rect_dist_np(clipped: np.ndarray, original: np.ndarray) -> np.ndarray:
    """Rowwise 1 - IoU (+1 convention) for crop filtering."""
    ai = (clipped[:, 2] - clipped[:, 0] + 1) * (clipped[:, 3] - clipped[:, 1] + 1)
    aj = (original[:, 2] - original[:, 0] + 1) * (original[:, 3] - original[:, 1] + 1)
    x1 = np.maximum(clipped[:, 0], original[:, 0])
    y1 = np.maximum(clipped[:, 1], original[:, 1])
    x2 = np.minimum(clipped[:, 2], original[:, 2])
    y2 = np.minimum(clipped[:, 3], original[:, 3])
    inter = (x2 - x1 + 1) * (y2 - y1 + 1) * ((x2 > x1) & (y2 > y1))
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = inter / (ai + aj - inter)
    iou = np.nan_to_num(iou, nan=0.0, posinf=0.0, neginf=0.0)
    return np.clip(1.0 - iou, 0.0, 1.0)


def _crop_params_and_boxes(
    shape_hw: tuple[int, int],
    bboxes: np.ndarray,  # (N, 4)
    input_size: tuple[int, int],
    neg_thresh: float,
    rng: np.random.Generator,
):
    """The draws and box math of crop_and_paste, without touching pixels.
    Returns (kept boxes in canvas coordinates, paste_box, (crop_y1, crop_x1,
    ch, cw, py, px))."""
    ih, iw = input_size
    crop_x1 = int(rng.integers(0, max(1, shape_hw[1] - iw + 1)))
    crop_y1 = int(rng.integers(0, max(1, shape_hw[0] - ih + 1)))
    crop_x2 = min(shape_hw[1], crop_x1 + iw)
    crop_y2 = min(shape_hw[0], crop_y1 + ih)
    ch, cw = crop_y2 - crop_y1, crop_x2 - crop_x1

    px = int(rng.integers(0, iw - cw + 1))
    py = int(rng.integers(0, ih - ch + 1))
    paste_box = np.array([px, py, px + cw, py + ch], np.float32)

    if bboxes.shape[0] > 0:
        clipped = bboxes.copy()
        clipped[:, 0] = np.maximum(clipped[:, 0], crop_x1)
        clipped[:, 1] = np.maximum(clipped[:, 1], crop_y1)
        clipped[:, 2] = np.minimum(clipped[:, 2], crop_x2)
        clipped[:, 3] = np.minimum(clipped[:, 3], crop_y2)
        overlap = 1.0 - _rect_dist_np(clipped, bboxes)

        out = bboxes.copy()
        out[:, [0, 2]] += px - crop_x1
        out[:, [1, 3]] += py - crop_y1
        out[:, 0] = np.clip(out[:, 0], 0, iw)
        out[:, 1] = np.clip(out[:, 1], 0, ih)
        out[:, 2] = np.clip(out[:, 2], 1, iw)
        out[:, 3] = np.clip(out[:, 3], 1, ih)

        good = (out[:, 2] > out[:, 0]) & (out[:, 3] > out[:, 1]) & (overlap >= neg_thresh)
        bboxes = out[good]

    return bboxes, paste_box, (crop_y1, crop_x1, ch, cw, py, px)


def crop_and_paste(
    img: np.ndarray,  # (H, W, 3) uint8
    bboxes: np.ndarray,  # (N, 4)
    input_size: tuple[int, int],
    neg_thresh: float,
    rng: np.random.Generator,
):
    """Random crop of `input_size`, pasted at a random offset onto a canvas
    prefilled with the ImageNet mean pixel (processor.py:41-112). Boxes are
    shifted into canvas coordinates, clipped, and dropped when the clipped
    box keeps < neg_thresh IoU with the original."""
    ih, iw = input_size
    bboxes, paste_box, (cy, cx, ch, cw, py, px) = _crop_params_and_boxes(
        img.shape[:2], bboxes, input_size, neg_thresh, rng
    )
    canvas = np.empty((ih, iw, 3), np.uint8)
    canvas[:] = MEAN_PIXEL
    canvas[py : py + ch, px : px + cw] = img[cy : cy + ch, cx : cx + cw]
    return canvas, bboxes, paste_box


class AugDraws(NamedTuple):
    """All random outcomes of one train-time augmentation, pixel-free.

    scale_id: 0 = x0.5, 1 = x1, 2 = x2 (reference wider_face.py:133-143).
    crop/paste coordinates are in RESIZED-image coordinates; (rh, rw) are
    the resized dims the crop was drawn on; (src_h, src_w) the original dims.
    """

    scale_id: int
    crop_y1: int
    crop_x1: int
    ch: int
    cw: int
    py: int
    px: int
    flip: bool
    rh: int
    rw: int
    src_h: int
    src_w: int


def augment_draws(
    shape_hw: tuple[int, int],
    bboxes: np.ndarray,
    cfg: DetectorConfig,
    rng: np.random.Generator,
):
    """Draws and GT box pipeline of the full train augmentation, without
    decoding or touching pixels (reference wider_face.py:133-165).

    Returns (AugDraws, gt (max_gt, 4), gt_valid (max_gt,), paste_box (4,))."""
    h, w = int(shape_hw[0]), int(shape_hw[1])
    r = rng.random()
    if r < 1 / 3 and min(h, w) >= 2:
        scale_id, rh, rw = 0, int(0.5 * h), int(0.5 * w)
        bboxes = bboxes / 2.0
    elif r > 2 / 3:
        scale_id, rh, rw = 2, 2 * h, 2 * w
        bboxes = bboxes * 2.0
    else:
        scale_id, rh, rw = 1, h, w

    bboxes, paste_box, (cy, cx, ch, cw, py, px) = _crop_params_and_boxes(
        (rh, rw), bboxes, cfg.input_size, cfg.neg_thresh, rng
    )

    flip = bool(rng.random() > 0.5)
    if flip and bboxes.shape[0] > 0:
        x1 = bboxes[:, 0].copy()
        x2 = bboxes[:, 2].copy()
        # MATLAB-indexing-aware mirror (wider_face.py:160-163).
        bboxes[:, 0] = cfg.input_size[1] - x2 + 1
        bboxes[:, 2] = cfg.input_size[1] - x1 + 1

    # Pad GT to the static bound; truncation is counted, never silent
    # (the reference handles unbounded counts, processor.py:213-277).
    overflow.record(bboxes.shape[0], cfg.max_gt)
    n = min(bboxes.shape[0], cfg.max_gt)
    gt = np.zeros((cfg.max_gt, 4), np.float32)
    gt[:n] = bboxes[:n]
    gt_valid = np.zeros(cfg.max_gt, bool)
    gt_valid[:n] = True

    draws = AugDraws(scale_id, cy, cx, ch, cw, py, px, flip, rh, rw, h, w)
    return draws, gt, gt_valid, paste_box


def augment_sample(
    img: np.ndarray,  # (H, W, 3) uint8 decoded image
    bboxes: np.ndarray,
    cfg: DetectorConfig,
    rng: np.random.Generator,
):
    """Full reference train-time augmentation of one sample
    (wider_face.py:133-165): random x0.5/x1/x2 resize, crop/paste, flip.
    Returns (canvas, gt, gt_valid, paste_box, flip)."""
    d, gt, gt_valid, paste_box = augment_draws(img.shape[:2], bboxes, cfg, rng)

    if d.scale_id != 1:
        img = _resize_uint8(img, (d.rh, d.rw))

    ih, iw = cfg.input_size
    canvas = np.empty((ih, iw, 3), np.uint8)
    canvas[:] = MEAN_PIXEL
    canvas[d.py : d.py + d.ch, d.px : d.px + d.cw] = img[
        d.crop_y1 : d.crop_y1 + d.ch, d.crop_x1 : d.crop_x1 + d.cw
    ]
    if d.flip:
        canvas = canvas[:, ::-1].copy()

    return canvas, gt, gt_valid, paste_box, d.flip


def _resize_uint8(img: np.ndarray, new_hw: tuple[int, int]) -> np.ndarray:
    """PIL bilinear resize of a uint8 image (the reference's transform)."""
    from PIL import Image

    return np.asarray(Image.fromarray(img).resize((new_hw[1], new_hw[0]), Image.BILINEAR))


class WIDERFace:
    """Dataset over a WIDER annotation file.

    split="train": __getitem__ returns the augmented fixed-shape sample dict,
    drawn from a generator that is a pure function of (seed, epoch, index).
    split="val"/"test": returns (decoded uint8 (H, W, 3) image, img_path).
    """

    def __init__(
        self,
        path: str | Path,
        templates: np.ndarray,
        cfg: DetectorConfig | None = None,
        dataset_root: str | Path = "",
        split: str = "train",
        seed: int = 0,
        debug: bool = False,
    ):
        self.cfg = cfg or DetectorConfig()
        self.split = split
        self.templates = templates
        self.dataset_root = Path(dataset_root)
        self.samples = parse_wider_annotations(path, split)
        self.seed = seed
        self.epoch = 0
        self.debug = debug

    def set_epoch(self, epoch: int) -> None:
        """Advance the augmentation stream: per-sample generators derive from
        (seed, epoch, index), so each epoch draws fresh augmentations while
        any (seed, epoch) pair is exactly reproducible."""
        self.epoch = int(epoch)

    def sample_rng(self, idx: int) -> np.random.Generator:
        """Per-sample generator, safe under the loader's worker threads (a
        shared np.random.Generator is not thread-safe)."""
        return np.random.default_rng(np.random.SeedSequence((self.seed, self.epoch, idx)))

    def __len__(self) -> int:
        return len(self.samples)

    def image_path(self, idx: int) -> Path:
        return self.dataset_root / f"WIDER_{self.split}" / "images" / self.samples[idx].img_path

    def _decode(self, idx: int) -> np.ndarray:
        """Decoded uint8 (H, W, 3) RGB pixels of sample `idx`."""
        from PIL import Image

        with Image.open(self.image_path(idx)) as im:
            return np.asarray(im.convert("RGB"))

    def get_dct(self, idx: int):
        raise NotImplementedError("the jpegdct eval wire is not ported: ROADMAP item 10")

    def getitem_train_dct(self, idx: int) -> dict:
        raise NotImplementedError("the jpegdct train wire is not ported: ROADMAP item 11")

    def get_all_bboxes(self) -> np.ndarray:
        """All GT boxes, the input of template clustering (reference
        wider_face.py:123-128)."""
        if not self.samples:
            return np.zeros((0, 4))
        return np.concatenate([s.bboxes for s in self.samples], axis=0)

    def __getitem__(self, idx: int):
        sample = self.samples[idx]
        if self.split == "train":
            canvas, gt, gt_valid, paste_box, flip = augment_sample(
                self._decode(idx), sample.bboxes.copy(), self.cfg, self.sample_rng(idx))
            return {"image": canvas, "gt_boxes": gt, "gt_valid": gt_valid,
                    "paste_box": paste_box, "flip": flip}
        return self._decode(idx), sample.img_path

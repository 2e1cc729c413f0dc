"""WIDER Face annotations and the evaluation dataset (val/test splits).

Port of the evaluation half of tinyfaces_tpu/data/wider_face.py. Annotation
format (reference wider_face.py:65-121): an image path line, a count line,
then `x y w h blur expression illumination invalid occlusion pose` rows; all
fields abs()'d, zero-w/h boxes dropped, (x, y, w, h) -> (x1, y1, x2, y2) with
the -1 MATLAB convention; a count of 0 is followed by one placeholder row.
The test split is a bare file list.

The training half (augmentation, crop-and-paste, GT-overflow accounting)
is not ported yet: `WIDERFace(split="train")` raises (ROADMAP item 3).
Pillow is imported only to decode an image.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional

import numpy as np

from tinyfaces_tpu.config import IMAGENET_MEAN, DetectorConfig

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


class WIDERFace:
    """Evaluation dataset over a WIDER annotation file: split "val" or
    "test"; __getitem__ returns (decoded uint8 (H, W, 3) image, img_path)."""

    def __init__(
        self,
        path: str | Path,
        templates: np.ndarray,
        cfg: DetectorConfig | None = None,
        dataset_root: str | Path = "",
        split: str = "val",
        debug: bool = False,
    ):
        if split == "train":
            raise ValueError("the WIDER training split (augmentation) is not ported yet: "
                             "ROADMAP item 3 (slice 3)")
        self.cfg = cfg or DetectorConfig()
        self.split = split
        self.templates = templates
        self.dataset_root = Path(dataset_root)
        self.samples = parse_wider_annotations(path, split)
        self.debug = debug

    def __len__(self) -> int:
        return len(self.samples)

    def image_path(self, idx: int) -> Path:
        return self.dataset_root / f"WIDER_{self.split}" / "images" / self.samples[idx].img_path

    def __getitem__(self, idx: int):
        from PIL import Image

        with Image.open(self.image_path(idx)) as im:
            return np.asarray(im.convert("RGB")), self.samples[idx].img_path

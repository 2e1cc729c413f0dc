"""Data layer of the port: templates, WIDER data (train augmentation and the
val/test splits), GT-overflow accounting, the C++ augmentation engine,
device-side targets, the batch loaders.

`load_templates` mirrors tinyfaces_tpu/data/__init__.py: it reads the
port's `templates.json` (a byte copy of the JAX package's) and rounds to 8
decimals. Re-clustering a missing file (`clustering/`) is not ported.
`get_dataloader` is the reference-compatible factory.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tinyfaces_tpu_torch.config import DetectorConfig
from tinyfaces_tpu_torch.data.wider_face import WIDERFace, parse_wider_annotations  # noqa: F401

TEMPLATE_FILE = Path(__file__).resolve().parent / "templates.json"


def load_templates(template_file: str | Path | None = None) -> np.ndarray:
    """(T, 5) template matrix [x1, y1, x2, y2, natural_scale], rounded to 8
    decimals. Raises FileNotFoundError when the file is missing."""
    template_file = Path(template_file or TEMPLATE_FILE)
    if not template_file.exists():
        raise FileNotFoundError(f"{template_file} missing; re-clustering templates from the "
                                "train boxes (clustering/) is not ported: see ROADMAP.md")
    with open(template_file) as f:
        templates = json.load(f)
    return np.round(np.array(templates, np.float64), decimals=8)


def get_dataloader(
    datapath: str | Path,
    args,
    num_templates: int = 25,
    template_file: str | Path | None = None,
    train: bool = False,
    split: str = "val",
    cfg: DetectorConfig | None = None,
):
    """Reference-compatible factory (reference datasets/__init__.py:11):
    returns (dataset, templates). `train=True` with split "train" gives the
    augmenting train dataset (batched by data/loader.py); val/test datasets
    are iterated per image."""
    if train != (split == "train"):
        raise ValueError(f"train={train} does not fit split={split!r}")
    del num_templates  # the JAX factory uses it only to re-cluster, which is not ported
    templates = load_templates(template_file)
    dataset = WIDERFace(datapath, templates, cfg=cfg,
                        dataset_root=Path(getattr(args, "dataset_root", "") or ""),
                        split=split, debug=getattr(args, "debug", False))
    return dataset, templates

"""Data layer of the port: templates, WIDER evaluation data, device-side
targets, the batch loader.

`load_templates` mirrors tinyfaces_tpu/data/__init__.py: it reads the
checked-in `tinyfaces_tpu/data/templates.json` by path (that package's
`data` module imports JAX, so it is not imported) and rounds to 8 decimals.
`get_dataloader` is the reference-compatible factory for the val/test
splits; the training split waits for ROADMAP item 3.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

import tinyfaces_tpu
from tinyfaces_tpu.config import DetectorConfig
from tinyfaces_tpu_torch.data.wider_face import WIDERFace, parse_wider_annotations  # noqa: F401

TEMPLATE_FILE = Path(tinyfaces_tpu.__file__).resolve().parent / "data" / "templates.json"


def load_templates(template_file: str | Path | None = None) -> np.ndarray:
    """(T, 5) template matrix [x1, y1, x2, y2, natural_scale], rounded to 8
    decimals. Raises FileNotFoundError when the file is missing."""
    template_file = Path(template_file or TEMPLATE_FILE)
    if not template_file.exists():
        raise FileNotFoundError(f"{template_file} missing (re-clustering is not ported)")
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
    returns (dataset, templates) for the val/test splits, iterated per
    image."""
    if train:
        raise ValueError("the WIDER training data is not ported yet: ROADMAP item 3 (slice 3)")
    del num_templates  # the JAX factory uses it only to re-cluster, which is not ported
    templates = load_templates(template_file)
    dataset = WIDERFace(datapath, templates, cfg=cfg,
                        dataset_root=Path(getattr(args, "dataset_root", "") or ""),
                        split=split, debug=getattr(args, "debug", False))
    return dataset, templates

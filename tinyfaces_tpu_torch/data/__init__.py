"""Data layer of the port: templates, WIDER data (train augmentation and the
val/test splits), GT-overflow accounting, the C++ augmentation engine,
device-side targets, the batch loaders.

`load_templates` mirrors tinyfaces_tpu/data/__init__.py: it reads the
port's `templates.json` (a byte copy of the JAX package's), or re-clusters
the train GT boxes with k-medoids (`clustering/`) when the file is missing
and persists the result; either way it rounds to 8 decimals.
`get_dataloader` is the reference-compatible factory.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from tinyfaces_tpu_torch.config import DetectorConfig
from tinyfaces_tpu_torch.data.wider_face import WIDERFace, parse_wider_annotations  # noqa: F401

TEMPLATE_FILE = Path(__file__).resolve().parent / "templates.json"


def load_templates(
    template_file: str | Path | None = None,
    traindata: str | Path | None = None,
    num_templates: int = 25,
) -> np.ndarray:
    """(T, 5) template matrix [x1, y1, x2, y2, natural_scale], rounded to 8
    decimals. When the file is missing, the boxes of the `traindata`
    annotation file are clustered into `num_templates` medoids, written to
    the file and returned as the JAX package does: (T, 4), without the
    natural-scale column. Missing with no `traindata` raises
    FileNotFoundError."""
    template_file = Path(template_file or TEMPLATE_FILE)
    if template_file.exists():
        with open(template_file) as f:
            templates = json.load(f)
    else:
        if traindata is None:
            raise FileNotFoundError(f"{template_file} missing and no traindata given to recluster")
        from tinyfaces_tpu_torch.clustering.cluster import compute_kmedoids

        dataset = WIDERFace(traindata, np.zeros((0, 5)))
        clustering = compute_kmedoids(dataset.get_all_bboxes(), 1, indices=num_templates,
                                      max_clusters=num_templates)
        templates = clustering[num_templates]["medoids"].tolist()
        with open(template_file, "w") as f:
            json.dump(templates, f)
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
    templates = load_templates(template_file, getattr(args, "traindata", None), num_templates)
    dataset = WIDERFace(datapath, templates, cfg=cfg,
                        dataset_root=Path(getattr(args, "dataset_root", "") or ""),
                        split=split, debug=getattr(args, "debug", False))
    return dataset, templates

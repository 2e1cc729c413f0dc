"""Configuration of the port: the same frozen dataclasses, fields and
defaults as tinyfaces_tpu/config.py, kept here so that the port imports
nothing of the JAX package (tests/test_torch_imports.py holds the two
equal).

Mirrors the hyper-parameter surface of the reference
(tinyfaces/datasets/wider_face.py:24-29,55 and main.py:18-36).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# ImageNet statistics used by the reference transforms (main.py:44-46).
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)

NUM_TEMPLATES = 25
NUM_OBJECTS = 1


@dataclasses.dataclass(frozen=True)
class ReceptiveField:
    """Receptive-field geometry of the score map (reference wider_face.py:55,
    detect_image.py:37): size 859, stride 8, offset -1 for a ResNet-101
    truncated after layer3 with the res3-resolution fused score map."""

    size: Tuple[int, int] = (859, 859)
    stride: Tuple[int, int] = (8, 8)
    offset: Tuple[int, int] = (-1, -1)


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Static detector hyper-parameters (reference wider_face.py:24-29)."""

    num_templates: int = NUM_TEMPLATES
    num_objects: int = NUM_OBJECTS
    input_size: Tuple[int, int] = (500, 500)
    heatmap_size: Tuple[int, int] = (63, 63)
    pos_thresh: float = 0.7
    neg_thresh: float = 0.3
    pos_fraction: float = 0.5
    sample_size: int = 256
    hard_neg_loss_thresh: float = 0.03  # loss.py:62 online hard-negative cutoff
    rf: ReceptiveField = ReceptiveField()
    # Static padding bound for the per-crop ground-truth count; boxes beyond
    # it are dropped and counted (data/overflow.py).
    max_gt: int = 192

    @property
    def out_channels(self) -> int:
        return (self.num_objects + 4) * self.num_templates


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training schedule (reference main.py:25-31,66-83)."""

    lr: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 5e-4
    batch_size: int = 12
    epochs: int = 50
    start_epoch: int = 0
    save_every: int = 10
    lr_step_epochs: int = 20
    lr_gamma: float = 0.1
    workers: int = 8


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation protocol (reference evaluate_model.py:24-25, evaluation.py:27)."""

    prob_thresh: float = 0.03
    nms_thresh: float = 0.3
    scales: Tuple[int, ...] = (-2, -1, 0, 1)  # pyramid exponents: 2**s
    # Static shape bounds of the decode: detections per scale kept by top-k
    # before cross-scale NMS, and max final detections.
    max_dets_per_scale: int = 1000
    max_total_dets: int = 750
    # Fold the 2x level's exact-2.0 bilinear upsample into conv1
    # (ops/stemfold.py): the stem runs at 1x and the 2x canvas is never
    # made; equal to resize-then-conv up to summation order.
    fold_stem: bool = True
    # Pyramid-level resampling kernel: "linear" (scale_and_translate linear,
    # antialiased) or "pil" (the reference's uint8 PIL bilinear,
    # ops/pilresize.py; rgb wire only).
    resample: str = "linear"
    # Per-scale template pruning: "reference" reproduces models/utils.py:
    # 15-44 with its dead type-B branch; "natural" lets the type-B templates
    # fire at upsampled scales.
    template_pruning: str = "reference"

"""Box algebra in continuous coordinates (torchvision's NMS convention).

Port of `box_area` and `pairwise_iou` of tinyfaces_tpu/ops/boxes.py, with
the same operation order so fp32 results agree bit for bit. The +1 (MATLAB)
convention of assignment and grading lives in ops/dense_overlap.py and is
kept apart on purpose.
"""

from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Continuous-coordinate area. boxes: (..., 4) as x1, y1, x2, y2."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """(..., N, M) IoU matrix of (..., N, 4) against (..., M, 4).

    Intersection clamped at 0; zero-union pairs give 0."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (x2 - x1).clamp_min(0.0) * (y2 - y1).clamp_min(0.0)
    union = box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))

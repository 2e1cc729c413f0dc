"""Detection loss: masked soft-margin classification + smooth-L1 regression.

Port of tinyfaces_tpu/loss.py (reference DetectionCriterion, loss.py:24-97):
  total = sum(mask_cls * softmargin(cls_logits, labels))
        + reg_weight * sum(mask_reg * smooth_l1(reg_pred, reg_targets))
with mask_cls = (label != 0), mask_reg = (label > 0) tiled over the four
tx/ty/tw/th blocks, after hard-negative mining and balance sampling, which
are label refinement with no gradient. Sum reduction, NHWC channel order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tinyfaces_tpu_torch.ops.sampling import (
    balance_sample_batch,
    hard_negative_mining,
    soft_margin_loss,
)


class LossBreakdown(NamedTuple):
    total: torch.Tensor
    class_loss: torch.Tensor
    reg_loss: torch.Tensor


def smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise SmoothL1 with beta=1 (reference loss.py:34)."""
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def detection_loss(
    output: torch.Tensor,  # (B, H, W, 5T) model output
    class_map: torch.Tensor,  # (B, H, W, T) labels in {-1, 0, +1}
    regress_map: torch.Tensor,  # (B, H, W, 4T) regression targets
    generator: torch.Generator | None,
    *,
    num_templates: int = 25,
    reg_weight: float = 1.0,
    pos_fraction: float = 0.5,
    sample_size: int = 256,
    hard_neg_thresh: float = 0.03,
    uniforms: tuple[torch.Tensor, torch.Tensor] | None = None,
    part: tuple[int, int] = (0, 1),
) -> LossBreakdown:
    """Sums over this batch; `part` = (rank, world) of a batch that is one
    rank's rows of a global batch (sampling.balance_sample_batch)."""
    nt = num_templates
    cls_logits = output[..., :nt]
    reg_pred = output[..., nt:]

    with torch.no_grad():
        labels = hard_negative_mining(cls_logits, class_map, hard_neg_thresh)
        labels = balance_sample_batch(labels, generator, sample_size, pos_fraction, uniforms,
                                      part)

    cls_mask = (labels != 0.0).to(output.dtype)
    cls_loss = torch.sum(cls_mask * soft_margin_loss(cls_logits, labels))

    reg_mask = (labels > 0.0).to(output.dtype).repeat(1, 1, 1, 4)
    reg_loss = torch.sum(reg_mask * smooth_l1(reg_pred, regress_map))

    total = cls_loss + reg_weight * reg_loss
    return LossBreakdown(total=total, class_loss=cls_loss, reg_loss=reg_loss)


class AvgMeter:
    """Host-side running average over sample count (reference loss.py:7-21)."""

    def __init__(self):
        self.average = 0.0
        self.num_averaged = 0

    def update(self, loss: float, size: int) -> None:
        n = self.num_averaged
        m = n + size
        self.average = ((n * self.average) + float(loss)) / m
        self.num_averaged = m

    def reset(self) -> None:
        self.average = 0.0
        self.num_averaged = 0

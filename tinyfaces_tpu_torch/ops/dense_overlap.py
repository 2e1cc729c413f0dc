"""Dense anchor-template vs. ground-truth IoU ("dense overlap").

Port of tinyfaces_tpu/ops/dense_overlap.py with the same MATLAB +1 pixel
convention and the same order of floating-point operations, so the two agree
to the last bit on the same inputs. Batched over a leading B axis.
"""

from __future__ import annotations

import torch


def compute_dense_overlap(
    ofx: float,
    ofy: float,
    stx: float,
    sty: float,
    vsx: int,
    vsy: int,
    templates: torch.Tensor,  # (T, >=4) [dx1, dy1, dx2, dy2, ...]
    gt_boxes: torch.Tensor,  # (B, G, 4) [x1, y1, x2, y2]
    gt_mask: torch.Tensor | None = None,  # (B, G) bool, False rows give 0 overlap
) -> torch.Tensor:
    """Returns the (B, vsy, vsx, T, G) IoU tensor, float32."""
    dev = gt_boxes.device
    templates = templates.to(dev, torch.float32)
    dx1, dy1, dx2, dy2 = (templates[:, i] for i in range(4))
    gx1, gy1, gx2, gy2 = (gt_boxes[..., i] for i in range(4))  # (B, G)

    filter_area = (dx2 - dx1 + 1.0) * (dy2 - dy1 + 1.0)  # (T,)
    bbox_area = (gx2 - gx1 + 1.0) * (gy2 - gy1 + 1.0)  # (B, G)

    cx = ofx + torch.arange(vsx, dtype=torch.float32, device=dev) * stx  # (X,)
    cy = ofy + torch.arange(vsy, dtype=torch.float32, device=dev) * sty  # (Y,)

    # Per-axis intersection extents, factored: (B, X, T, G) and (B, Y, T, G).
    def extent(c, d1, d2, g1, g2):
        lo = torch.maximum(c[None, :, None, None] + d1[None, None, :, None], g1[:, None, None, :])
        hi = torch.minimum(c[None, :, None, None] + d2[None, None, :, None], g2[:, None, None, :])
        return hi - lo + 1.0

    int_w = extent(cx, dx1, dx2, gx1, gx2)
    int_h = extent(cy, dy1, dy2, gy1, gy2)

    int_area = int_h[:, :, None] * int_w[:, None]  # (B, Y, X, T, G)
    valid = (int_h[:, :, None] > 0) & (int_w[:, None] > 0)
    union = filter_area[None, None, None, :, None] + bbox_area[:, None, None, None, :] - int_area
    iou = torch.where(valid, int_area / union, 0.0)

    if gt_mask is not None:
        iou = torch.where(gt_mask[:, None, None, None, :], iou, 0.0)
    return iou

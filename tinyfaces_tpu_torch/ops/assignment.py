"""Ground-truth assignment: border mask and the label composition.

Port of tinyfaces_tpu/ops/assignment.py. The dense IoU reductions live in
ops/assignment_kernel.py (a CUDA kernel and its plain PyTorch twin); this
module holds what both back ends share: `compute_pad_mask` and
`compose_targets`, which turns the reductions into class and regression maps
with the reference's rules (processor.py:114-277):

  1. each GT's best anchor (argmax over all Y*X*T locations of the perturbed
     IoU) is forced positive if its IoU > neg_thresh — an OR when several
     GTs share a best anchor;
  2. anchors whose best IoU >= pos_thresh are positive;
  3. anchors whose best IoU lies in [neg_thresh, pos_thresh) are ignored;
  4. with no valid GT the class map is all negative and regression all zero;
  5. anchors crossing the pasted-crop border that are not negative become
     ignore, and only their tx regression block is zeroed (reference quirk).

Label alphabet: -1 negative, 0 ignore, +1 positive. Layouts follow the JAX
package: class maps (B, Y, X, T), regression (B, Y, X, 4T) as tx|ty|tw|th
blocks, flat anchor indices in C order over (Y, X, T).
"""

from __future__ import annotations

import torch


def compute_pad_mask(
    paste_box: torch.Tensor,  # (B, 4) [x1, y1, x2, y2] of the pasted crop
    templates: torch.Tensor,  # (T, >=4)
    ofx: float,
    ofy: float,
    stx: float,
    sty: float,
    vsx: int,
    vsy: int,
    flip: torch.Tensor,  # (B,) bool
) -> torch.Tensor:
    """(B, vsy, vsx, T) bool mask of anchors that cross the pasted-crop
    border, with the MATLAB +1 on the lower bounds, mirrored in x where the
    sample was flipped (wider_face.py:165)."""
    dev = paste_box.device
    templates = templates.to(dev, torch.float32)
    cx = ofx + torch.arange(vsx, dtype=torch.float32, device=dev) * stx  # (X,)
    cy = ofy + torch.arange(vsy, dtype=torch.float32, device=dev) * sty  # (Y,)
    dx1, dy1, dx2, dy2 = (templates[:, i] for i in range(4))
    pb = paste_box[:, :, None, None, None]  # (B, 4, 1, 1, 1)

    padx1 = cx[None, :, None] + dx1[None, None, :] < pb[:, 0] + 1
    pady1 = cy[:, None, None] + dy1[None, None, :] < pb[:, 1] + 1
    padx2 = cx[None, :, None] + dx2[None, None, :] > pb[:, 2]
    pady2 = cy[:, None, None] + dy2[None, None, :] > pb[:, 3]
    mask = padx1 | pady1 | padx2 | pady2  # (B, Y, X, T)
    return torch.where(flip[:, None, None, None], mask.flip(2), mask)


def compose_targets(
    best_iou: torch.Tensor,  # (B, Y, X, T) max over GT of the perturbed IoU
    best_gt: torch.Tensor,  # (B, Y, X, T) its first argmax
    pgt_max: torch.Tensor,  # (B, G) per-GT max over all anchors
    pgt_idx: torch.Tensor,  # (B, G) its flat C-order argmax over (Y, X, T)
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G) bool, degenerate boxes already dropped
    pad_mask: torch.Tensor,  # (B, Y, X, T) bool
    templates: torch.Tensor,  # (T, >=4)
    *,
    ofx: float,
    ofy: float,
    stx: float,
    sty: float,
    pos_thresh: float,
    neg_thresh: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (class_map (B,Y,X,T), regress_map (B,Y,X,4T)), float32."""
    b, vsy, vsx, nt = best_iou.shape
    dev = best_iou.device
    templates = templates.to(dev, torch.float32)
    any_gt = gt_valid.any(dim=1)[:, None, None, None]  # (B, 1, 1, 1)

    # --- Classification map ---------------------------------------------
    # Forced positives: set (not accumulate) True at each forcing GT's best
    # anchor, so GTs sharing an anchor OR together deterministically.
    # A GT that forces nothing writes to a spare column, so the scatter has
    # a fixed shape and never waits on the host (CUDA-graph capturable).
    n = vsy * vsx * nt
    force = (pgt_max > neg_thresh) & gt_valid  # (B, G)
    idx = torch.where(force, pgt_idx.long(), n)
    best_anchor = torch.zeros(b, n + 1, dtype=torch.bool, device=dev).scatter_(1, idx, True)
    best_anchor = best_anchor[:, :n].reshape(b, vsy, vsx, nt)

    class_map = torch.where(best_anchor, 1.0, -1.0)
    class_map = torch.maximum(class_map, (best_iou >= pos_thresh) * 2.0 - 1.0)
    gray = torch.where((best_iou >= neg_thresh) & (best_iou < pos_thresh), 0.0, -1.0)
    class_map = torch.maximum(class_map, gray)
    class_map = torch.where(any_gt, class_map, -1.0)

    # --- Regression map: per-anchor best GT, +1 size convention ----------
    coarse_x = ofx + torch.arange(vsx, dtype=torch.float32, device=dev) * stx
    coarse_y = ofy + torch.arange(vsy, dtype=torch.float32, device=dev) * sty
    dww = templates[:, 2] - templates[:, 0] + 1.0
    dhh = templates[:, 3] - templates[:, 1] + 1.0

    stats = torch.stack(
        [
            (gt_boxes[..., 0] + gt_boxes[..., 2]) / 2.0,  # fcx
            (gt_boxes[..., 1] + gt_boxes[..., 3]) / 2.0,  # fcy
            gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0,  # fww
            gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0,  # fhh
        ],
        dim=1,
    )  # (B, 4, G)
    # A true fp32 gather (the JAX package's one-hot matmul is a TPU detour).
    idx = best_gt.reshape(b, 1, -1).long().expand(b, 4, -1)
    sel = torch.gather(stats, 2, idx).view(b, 4, vsy, vsx, nt)
    sel_cx, sel_cy, sel_w, sel_h = sel.unbind(1)

    tx = (sel_cx - coarse_x[None, None, :, None]) / dww
    ty = (sel_cy - coarse_y[None, :, None, None]) / dhh
    tw = torch.log(sel_w / dww)
    th = torch.log(sel_h / dhh)

    # --- Border handling (tx-block-only zeroing, reference quirk) ---------
    non_neg_border = pad_mask & (class_map != -1.0)
    class_map = torch.where(non_neg_border, 0.0, class_map)
    tx = torch.where(non_neg_border, 0.0, tx)
    regress_map = torch.cat([tx, ty, tw, th], dim=3)
    regress_map = torch.where(any_gt, regress_map, 0.0)
    return class_map, regress_map

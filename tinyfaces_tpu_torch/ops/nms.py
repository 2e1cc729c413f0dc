"""Exact greedy non-maximum suppression with a static output shape, batched.

Port of tinyfaces_tpu/ops/nms.py with torchvision's semantics: continuous
coordinate IoU, a candidate is suppressed when its IoU with an already kept,
higher-ranked box is > the threshold, and invalid (padding) rows are never
kept. The ranking is a stable descending sort, as `jnp.argsort` is stable,
so equal scores keep their input order.

The keep step follows the tensors' device, as K1 does:

* CUDA tensors launch the hand-written kernel N1 (ops/nms_kernel.py,
  csrc/nms.cu), or raise if it cannot be built or launched. It reads each
  image's valid extent on the device and makes no host read, as the JAX
  module promises: the whole NMS lives on the device, and the pyramid
  around it is captured into one CUDA graph (evaluation.PyramidDetector).
* CPU tensors take the plain version, `_plain_keep`: `_fixpoint_keep`, the
  Jacobi fixpoint of `keep[i] = valid[i] and no kept j ranked above i overlaps i`
  over the dense (n, n) overlap mask. Row i is final once every row that
  can suppress it is, so the fixpoint is the exact greedy result, reached
  in as many sweeps as the longest suppression chain. Only the first n
  ranked rows take part, n the largest valid extent of any image (one past
  its last valid rank); the host reads n once per call and tests
  convergence once every `_SWEEPS_PER_CHECK` sweeps, which costs nothing
  on the CPU.
"""

from __future__ import annotations

import torch

from tinyfaces_tpu_torch.ops import nms_kernel
from tinyfaces_tpu_torch.ops.boxes import pairwise_iou

_SWEEPS_PER_CHECK = 4
_MAX_MASK_ELEMENTS = 1 << 26  # bounds the (images, n, n) IoU matrix of one chunk


def _fixpoint_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """(b, n, 4) rank-sorted boxes, (b, n) validity -> (b, n) greedy keep."""
    n = boxes.shape[1]
    ranked_above = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    # upper[b, j, i]: higher-ranked j overlaps lower-ranked i enough.
    upper = (pairwise_iou(boxes, boxes) > iou_threshold) & ranked_above
    upper = upper.to(torch.float32 if boxes.device.type == "cpu" else torch.bfloat16)
    keep = valid
    while True:
        prev = keep
        for _ in range(_SWEEPS_PER_CHECK):
            # bf16 products of 0/1 with fp32 accumulation: > 0 is exact.
            hits = torch.bmm(keep[:, None, :].to(upper.dtype), upper)[:, 0]
            keep = valid & ~(hits > 0)
        if torch.equal(keep, prev):
            return keep


def nms(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    iou_threshold: float,
    valid: torch.Tensor | None = None,  # (B, N) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS per image. Returns `(order, keep)`: `order` is the (B, N)
    stable descending-score permutation and `keep` the (B, N) bool mask in
    that order. The keep step runs in N1 on CUDA tensors and in the plain
    fixpoint on CPU tensors."""
    b, n = scores.shape
    if valid is None:
        valid = torch.ones(b, n, dtype=torch.bool, device=scores.device)

    ranked = torch.where(valid, scores, -torch.inf)
    order = torch.sort(ranked, dim=1, descending=True, stable=True).indices
    boxes_sorted = boxes.gather(1, order[..., None].expand(b, n, 4))
    valid_sorted = valid.gather(1, order)

    if boxes.device.type == "cpu":
        return order, _plain_keep(boxes_sorted, valid_sorted, iou_threshold)
    return order, nms_kernel._launch(boxes_sorted, valid_sorted, iou_threshold)


def _plain_keep(boxes_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """The plain keep step on any device (the CPU route of nms): the
    fixpoint over the first n = the largest valid extent of any image (one
    past its last valid rank), in chunks of images that bound the (images,
    n, n) mask. Reads n on the host."""
    b = valid_sorted.shape[0]
    keep = valid_sorted.clone()
    # Rows past the last valid one neither keep nor suppress. nms() ranks
    # the valid rows first, so there n is the largest valid count; a mask
    # with holes (the keep step's contract allows one) reaches further.
    nv = int(nms_kernel.valid_extent(valid_sorted).max()) if b else 0
    if nv:
        chunk = max(1, _MAX_MASK_ELEMENTS // (nv * nv))
        for s in range(0, b, chunk):
            keep[s:s + chunk, :nv] = _fixpoint_keep(
                boxes_sorted[s:s + chunk, :nv], valid_sorted[s:s + chunk, :nv], iou_threshold)
    return keep


def batched_nms_padded(
    boxes: torch.Tensor,  # (B, N, 4)
    scores: torch.Tensor,  # (B, N)
    iou_threshold: float,
    valid: torch.Tensor,  # (B, N) bool
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NMS returning `(out_boxes, out_scores, out_valid)` of (B, M) rows,
    M = min(N, max_out): kept detections packed first in descending-score
    order, zeros past the kept count."""
    b, n = scores.shape
    order, keep = nms(boxes, scores, iou_threshold, valid)
    pos = torch.arange(n, device=scores.device).expand(b, n)
    # Kept rows first, each group in rank order.
    rank = torch.argsort(torch.where(keep, pos, n + pos), dim=1)[:, :max_out]
    src = order.gather(1, rank)
    packed_valid = keep.gather(1, rank)
    packed_boxes = boxes.gather(1, src[..., None].expand(*src.shape, 4))
    packed_scores = scores.gather(1, src)
    packed_boxes = torch.where(packed_valid[..., None], packed_boxes, 0.0)
    packed_scores = torch.where(packed_valid, packed_scores, 0.0)
    return packed_boxes, packed_scores, packed_valid

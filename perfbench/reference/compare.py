"""The numbers that decide a detection cell's `correct`.

For the port's detections P (N, 5) of one image and the reference's R
(`pyramid.detect`), all in logits:

* `score_gap`: for each row of P, the reference's cells (every level,
  every template that may fire there, every cell of the level's own rows
  and columns) whose decoded box overlaps it with IoU >= MATCH_IOU, and of
  those the smallest difference of the logit; the largest over P. A row with no such cell (a box the
  reference never produces) reads NO_MATCH. It catches a score or a box
  altered, a wrong level or scale, a wrong decode.
* `miss`: for each reference detection r, the rows of P that overlap it by
  more than nms_thresh - COVER_SLACK (r's own row, or a row that
  suppressed r, the slack for IoUs that rounding moves across the
  threshold): the
  smallest amount by which r's logit exceeds such a row's, or the amount
  by which it clears the nearest edge it may have fallen out at if that is
  less: the threshold, its level's 1000th cell, the 750th kept row. The
  largest over R. It catches detections lost: images or levels left out,
  NMS that suppresses too much, a cut top-K.
* `overlap`: the largest IoU between two rows of P; NMS keeps none above
  nms_thresh, the configuration's own limit.

Rounding moves a logit, and so which of two near rows NMS keeps and which
cell is 1000th; these rules account for that without a tolerance of their
own: a flip is explained by the row that won it.
"""

from __future__ import annotations

import torch

from perfbench.reference.pyramid import iou_matrix

MATCH_IOU = 0.7
NO_MATCH = 100.0
COVER_SLACK = 0.02  # rounding moves two boxes' IoU near nms_thresh across it


def pair_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of broadcast (..., 4) boxes."""
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp_min(0)
    inter = iw * ih
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]) - inter)
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def anchor_gaps(port: torch.Tensor, ref: dict, chunk: int = 1 << 25) -> torch.Tensor:
    """(N,) the smallest logit difference of each port row to a reference
    cell whose box matches it (inf where none does)."""
    best = torch.full((len(port),), torch.inf, dtype=torch.float64, device=port.device)
    box = port[:, :4].float()
    for lv in ref["levels"]:
        cells, logits = lv["boxes"].float(), lv["logits"].double()
        if not len(cells):
            continue
        step = max(1, chunk // len(cells))
        for i in range(0, len(port), step):
            ok = pair_iou(box[i:i + step, None, :], cells[None, :, :]) >= MATCH_IOU
            diff = (logits[None, :] - port[i:i + step, 4:5]).abs()
            best[i:i + step] = torch.minimum(best[i:i + step], torch.where(ok, diff, torch.inf).amin(1))
    return best


def numbers(port, ref: dict, nms_thresh: float) -> dict:
    """The three numbers of one image; `port` (N, 5), `ref` from
    pyramid.detect (its tensors' device does the arithmetic)."""
    final = ref["final"]
    port = torch.as_tensor(port, dtype=torch.float64).reshape(-1, 5).to(final.device)
    gap = 0.0
    if len(port):
        gap = float(anchor_gaps(port, ref).clamp(max=NO_MATCH).max())
    miss = 0.0
    if len(final):
        cut = torch.tensor(ref["cuts"], dtype=torch.float64, device=final.device)[ref["final_level"]]
        edge = torch.maximum(cut, torch.tensor([ref["thr_logit"], ref["final_cut"]], dtype=torch.float64,
                                               device=final.device).max())
        per = final[:, 4] - edge
        if len(port):
            cover = iou_matrix(final, port) > nms_thresh - COVER_SLACK
            excess = torch.where(cover, final[:, 4:5] - port[None, :, 4], torch.inf).amin(1)
            per = torch.minimum(per, excess)
        miss = float(per.clamp_min(0.0).max())
    overlap = 0.0
    if len(port) > 1:
        iou = iou_matrix(port, port)
        iou.fill_diagonal_(0.0)
        overlap = float(iou.max())
    return {"score_gap": gap, "miss": miss, "overlap": overlap}


def explain_miss(port, ref: dict, nms_thresh: float) -> dict:
    """The reference row behind `miss` and the port rows nearest it (a look
    at a reading, for tools/control.py)."""
    final = ref["final"]
    port = torch.as_tensor(port, dtype=torch.float64).reshape(-1, 5).to(final.device)
    cut = torch.tensor(ref["cuts"], dtype=torch.float64, device=final.device)[ref["final_level"]]
    edge = torch.maximum(cut, torch.tensor([ref["thr_logit"], ref["final_cut"]], dtype=torch.float64,
                                           device=final.device).max())
    per = final[:, 4] - edge
    iou = iou_matrix(final, port) if len(port) else torch.zeros((len(final), 0), dtype=torch.float64)
    if len(port):
        excess = torch.where(iou > nms_thresh - COVER_SLACK, final[:, 4:5] - port[None, :, 4],
                             torch.inf).amin(1)
        per = torch.minimum(per, excess)
    i = int(per.argmax())
    near = torch.argsort(iou[i], descending=True)[:3] if len(port) else []
    return {"miss": float(per[i]), "ref_row": final[i].tolist(), "level": int(ref["final_level"][i]),
            "edge": float(edge[i]), "rank": i, "kept": len(final),
            "near": [[float(iou[i, j])] + port[j].tolist() for j in near]}


def worst(per_image: list) -> dict:
    """The largest of each number over images."""
    keys = ("score_gap", "miss", "overlap")
    return {k: max([p[k] for p in per_image], default=0.0) for k in keys}

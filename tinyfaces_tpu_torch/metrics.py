"""Detection metrics of the port: IoU distances, VOC AP, dataset-level
average precision. Plain NumPy on the host.

The port's copy of tinyfaces_tpu/metrics.py (voc_ap, average_precision,
compute_model_score) and of the JAX package's `rect_dist` and
`jaccard_index` (tinyfaces_tpu/ops/boxes.py), which are jnp there: the same
formulas in float64 NumPy, with the reference's two quirks kept:

* `rect_dist` counts the intersection only where x2 > x1 and y2 > y1 and
  clamps 1 - IoU into [0, 1];
* `jaccard_index` does not clamp the intersection at zero: disjoint boxes
  give a negative "intersection", and only a union <= 0 gives 0. Template
  clustering depends on it.

The WIDER easy/medium/hard protocol is in `wider_eval.py`.
"""

from __future__ import annotations

import json
from typing import Sequence

import numpy as np


def _area_plus1(boxes: np.ndarray) -> np.ndarray:
    """Area with the MATLAB +1 convention. boxes: (..., 4) as x1,y1,x2,y2."""
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)


def rect_dist(i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """1 - IoU with +1 pixel arithmetic, elementwise over matched box rows
    (reference metrics.py:44-74)."""
    i = np.atleast_2d(np.asarray(i, np.float64))
    j = np.atleast_2d(np.asarray(j, np.float64))
    x1 = np.maximum(i[..., 0], j[..., 0])
    y1 = np.maximum(i[..., 1], j[..., 1])
    x2 = np.minimum(i[..., 2], j[..., 2])
    y2 = np.minimum(i[..., 3], j[..., 3])
    aij = (x2 - x1 + 1.0) * (y2 - y1 + 1.0) * ((x2 > x1) & (y2 > y1))
    denom = _area_plus1(i) + _area_plus1(j) - aij
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(denom != 0, aij / denom, 0.0)
    iou = np.where(np.isfinite(iou), iou, 0.0)
    return np.clip(1.0 - iou, 0.0, 1.0)


def jaccard_index(box_a: np.ndarray, box_b: np.ndarray) -> np.ndarray:
    """IoU in continuous coordinates (reference metrics.py:8-41), with the
    unclamped intersection. Boxes are (4,) or (4, ...) coordinate-first."""
    box_a = np.asarray(box_a, np.float64)
    box_b = np.asarray(box_b, np.float64)
    area_a = (box_a[2] - box_a[0]) * (box_a[3] - box_a[1])
    area_b = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    xa = np.maximum(box_a[0], box_b[0])
    ya = np.maximum(box_a[1], box_b[1])
    xb = np.minimum(box_a[2], box_b[2])
    yb = np.minimum(box_a[3], box_b[3])
    intersection = (xb - xa) * (yb - ya)
    union = area_a + area_b - intersection
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union <= 0, 0.0, intersection / union)


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False) -> float:
    """VOC average precision from a recall/precision curve.

    use_07_metric selects the 11-point interpolation; default is the exact
    area under the interpolated PR envelope (reference metrics.py:77-98).
    """
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)

    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    # precision envelope (monotone non-increasing from the right)
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    changed = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[changed + 1] - mrec[changed]) * mpre[changed + 1]))


def _iou_one_vs_many(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Continuous-coordinate IoU of one box against (N, 4) boxes."""
    x1 = np.maximum(boxes[:, 0], box[0])
    y1 = np.maximum(boxes[:, 1], box[1])
    x2 = np.minimum(boxes[:, 2], box[2])
    y2 = np.minimum(boxes[:, 3], box[3])
    inter = np.maximum(x2 - x1, 0.0) * np.maximum(y2 - y1, 0.0)
    union = (
        (box[2] - box[0]) * (box[3] - box[1])
        + (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        - inter
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return iou


def average_precision(
    confidence: np.ndarray,  # (D,)
    dets: np.ndarray,  # (D, 4) x1, y1, x2, y2
    image_ids: Sequence,  # (D,) image id per detection
    class_recs: dict,  # image id -> {"bbox": (N, 4) xywh, "det": [bool]*N}
    npos: int,
    ovthresh: float = 0.5,
):
    """Greedy-matching AP over a detection set (reference metrics.py:100-161).

    GT boxes come in (x, y, w, h) and are converted with the -1 MATLAB
    convention, as in the reference. Marks the matched GTs in `class_recs`.
    """
    order = np.argsort(-confidence)
    dets = dets[order]
    img_ids = [image_ids[i] for i in order]

    nd = len(img_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)

    for d in range(nd):
        rec = class_recs[img_ids[d]]
        gt = rec["bbox"].astype(np.float64).copy()
        if gt.size > 0:
            gt[:, 2] = gt[:, 0] + gt[:, 2] - 1
            gt[:, 3] = gt[:, 1] + gt[:, 3] - 1
            overlaps = _iou_one_vs_many(dets[d].astype(np.float64), gt)
            jmax = int(np.argmax(overlaps))
            ovmax = overlaps[jmax]
        else:
            ovmax, jmax = -np.inf, -1

        if ovmax > ovthresh and not rec["det"][jmax]:
            tp[d] = 1.0
            rec["det"][jmax] = True
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / float(max(npos, 1))
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return voc_ap(recall, precision), precision, recall


def compute_model_score(pred_file: str, gt_file: str, class_id: int = 3):
    """COCO-ish JSON evaluation entry point (reference metrics.py:164-205):
    GT as a JSON list of {image: {id}, bboxes: [{category_id, bbox}]},
    predictions as JSONL of {id, confidences, bboxes}."""
    with open(gt_file) as f:
        gt = json.load(f)
    recs = {g["image"]["id"]: g["bboxes"] for g in gt}

    class_recs = {}
    npos = 0
    for img_id, objs in recs.items():
        rows = [o for o in objs if o["category_id"] == class_id]
        class_recs[img_id] = {
            "bbox": np.array([o["bbox"] for o in rows]).reshape(len(rows), 4),
            "det": [False] * len(rows),
        }
        npos += len(rows)

    confidence, boxes, image_ids = [], [], []
    with open(pred_file) as f:
        for line in f:
            p = json.loads(line)
            confidence.extend(p["confidences"])
            boxes.extend(p["bboxes"])
            image_ids.extend([p["id"]] * len(p["confidences"]))

    return average_precision(
        np.asarray(confidence), np.asarray(boxes).reshape(-1, 4), image_ids,
        class_recs, npos,
    )

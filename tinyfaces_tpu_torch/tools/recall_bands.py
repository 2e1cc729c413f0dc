"""Per-height-band recall@0.5 over a WIDER-format result tree.

    python -m tinyfaces_tpu_torch.tools.recall_bands --results DIR \\
        --gt wider_face_val_bbx_gt.txt

Attribution diagnostic for the closed-loop accuracy tool: AP is one scalar
over all bands; this splits the miss mass by GT pixel height, so an AP
plateau can be pinned on tiny-face recall rather than on matching, grading
or large-face regression.

Score-independent on purpose: greedy best-IoU match per GT, any detection
counts regardless of confidence — an upper bound on each band's
achievable recall through the grader.

The port of tools/recall_bands.py, on the port's grader
(tinyfaces_tpu_torch.wider_eval).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from tinyfaces_tpu_torch.wider_eval import gt_from_txt, read_results_dir

BANDS = ((10, 30), (30, 50), (50, 100), (100, 10_000))


def _iou(d: np.ndarray, g: np.ndarray) -> np.ndarray:
    """IoU matrix, xywh boxes, +1 pixel-area convention."""
    dx1, dy1 = d[:, 0], d[:, 1]
    dx2, dy2 = d[:, 0] + d[:, 2] - 1, d[:, 1] + d[:, 3] - 1
    gx1, gy1 = g[:, 0], g[:, 1]
    gx2, gy2 = g[:, 0] + g[:, 2] - 1, g[:, 1] + g[:, 3] - 1
    iw = np.clip(np.minimum(dx2[:, None], gx2) - np.maximum(dx1[:, None], gx1) + 1, 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2) - np.maximum(dy1[:, None], gy1) + 1, 0, None)
    inter = iw * ih
    area_d = (dx2 - dx1 + 1) * (dy2 - dy1 + 1)
    area_g = (gx2 - gx1 + 1) * (gy2 - gy1 + 1)
    return inter / np.maximum(area_d[:, None] + area_g - inter, 1e-12)


def recall_bands(results_dir: str | Path, gt_txt: str | Path,
                 iou_thresh: float = 0.5) -> dict:
    gt, keeps = gt_from_txt(gt_txt)
    results = read_results_dir(results_dir)
    hits = {b: 0 for b in BANDS}
    total = {b: 0 for b in BANDS}
    n_dets = 0
    for img, g in gt.items():
        d = results.get(img, np.zeros((0, 5)))
        n_dets += d.shape[0]
        if g.shape[0] == 0:
            continue
        valid = keeps["all"][img]
        best = (_iou(d[:, :4].astype(np.float64), g.astype(np.float64)).max(0)
                if d.shape[0] else np.zeros(g.shape[0]))
        h = g[:, 3]
        for lo, hi in BANDS:
            sel = valid & (h >= lo) & (h < hi)
            hits[(lo, hi)] += int((best[sel] >= iou_thresh).sum())
            total[(lo, hi)] += int(sel.sum())
    return {
        f"{lo}-{hi}px": {
            "recall": round(hits[(lo, hi)] / max(total[(lo, hi)], 1), 3),
            "gt": total[(lo, hi)],
        }
        for lo, hi in BANDS
    } | {"detections": n_dets,
         "gt_total": int(sum(total.values()))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", required=True,
                    help="WIDER-format result tree (evaluate_model output)")
    ap.add_argument("--gt", required=True, help="wider_face_val_bbx_gt.txt")
    ap.add_argument("--iou", type=float, default=0.5)
    args = ap.parse_args(argv)
    bands = recall_bands(args.results, args.gt, args.iou)
    print(json.dumps(bands, indent=1))
    return bands


if __name__ == "__main__":
    main()

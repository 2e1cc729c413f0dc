"""WIDER Face mAP evaluator of the port — the surface of the root
wider_eval.py, flag for flag, with its printed and JSON output:

    python -m tinyfaces_tpu_torch.wider_eval wider_face_val_bbx_gt.txt \\
        --results-dir val_results [--eval-tools-dir eval_tools] [--out scores.json]

The official WIDER evaluation protocol in NumPy (no JAX, no PIL; scipy only
for the official .mat ground truth):
  * detections read from the WIDER-format result tree written by
    evaluate_model (<results_dir>/<event>/<img>.txt);
  * per-image greedy matching at IoU >= 0.5, detections in descending score
    order, each GT matched at most once;
  * global min-max score normalization and a 1000-point PR curve;
  * AP by VOC-style interpolated area under the PR envelope.

Ground truth sources, in order of preference:
  1. `--eval-tools-dir` pointing at the official eval_tools/ground_truth
     .mat files (wider_face_val.mat + wider_{easy,medium,hard}_val.mat) —
     exact easy/medium/hard splits (requires scipy);
  2. the bbx_gt.txt annotation file — overall AP over all faces, plus
     approximate easy/medium/hard bands by GT pixel height (the official
     splits are curated lists, not pure height thresholds).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from tinyfaces_tpu_torch.data.wider_face import parse_wider_annotations
from tinyfaces_tpu_torch.metrics import voc_ap

IOU_THRESH = 0.5
N_THRESH = 1000


def read_results_dir(results_dir: str | Path) -> dict[str, np.ndarray]:
    """img_path (event/name.jpg) -> (N, 5) [x, y, w, h, score] detections."""
    out = {}
    for txt in sorted(Path(results_dir).glob("*/*.txt")):
        lines = txt.read_text().splitlines()
        n = int(lines[1])
        rows = np.zeros((n, 5))
        for i in range(n):
            rows[i] = [float(v) for v in lines[2 + i].split()]
        out[f"{txt.parent.name}/{txt.stem}.jpg"] = rows
    return out


def _iou_matrix(dets_xyxy: np.ndarray, gts_xyxy: np.ndarray) -> np.ndarray:
    """(D, G) IoU with the +1 pixel convention (the official boxoverlap.m)."""
    x1 = np.maximum(dets_xyxy[:, None, 0], gts_xyxy[None, :, 0])
    y1 = np.maximum(dets_xyxy[:, None, 1], gts_xyxy[None, :, 1])
    x2 = np.minimum(dets_xyxy[:, None, 2], gts_xyxy[None, :, 2])
    y2 = np.minimum(dets_xyxy[:, None, 3], gts_xyxy[None, :, 3])
    inter = np.maximum(x2 - x1 + 1, 0) * np.maximum(y2 - y1 + 1, 0)
    area_d = (dets_xyxy[:, 2] - dets_xyxy[:, 0] + 1) * (dets_xyxy[:, 3] - dets_xyxy[:, 1] + 1)
    area_g = (gts_xyxy[:, 2] - gts_xyxy[:, 0] + 1) * (gts_xyxy[:, 3] - gts_xyxy[:, 1] + 1)
    union = area_d[:, None] + area_g[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / union, 0.0)


def image_eval(dets: np.ndarray, gts: np.ndarray, keep_mask: np.ndarray):
    """Official image_evaluation semantics: greedy match dets (desc score).

    dets: (D, 5) xywh+score. gts: (G, 4) xywh. keep_mask: (G,) bool — GTs in
    the difficulty split.
    Returns (scores desc, flags): 1 = TP (new match to a kept GT), 0 = FP
    (no match, or duplicate match to an already-matched kept GT), -1 =
    excluded (best-overlap GT is outside the split — EVERY such detection
    is excluded, the official tool's persistent recall_list = -1 state).

    Boxes convert xywh -> xyxy as x2 = x + w with NO -1 while the overlap
    uses the +1 convention — the official boxoverlap.m's 1-px-widened IoU,
    reproduced as-is.
    """
    d = dets[np.argsort(-dets[:, 4], kind="stable")]
    dx = d[:, :4].astype(np.float64)
    gx = gts.astype(np.float64)
    dx2 = np.stack([dx[:, 0], dx[:, 1], dx[:, 0] + dx[:, 2], dx[:, 1] + dx[:, 3]], 1)
    gx2 = np.stack([gx[:, 0], gx[:, 1], gx[:, 0] + gx[:, 2], gx[:, 1] + gx[:, 3]], 1)

    flags = np.zeros(d.shape[0])
    if gts.shape[0] == 0:
        return d[:, 4], flags

    iou = _iou_matrix(dx2, gx2)
    matched = np.zeros(gts.shape[0], dtype=bool)
    for i in range(d.shape[0]):
        j = int(np.argmax(iou[i]))
        if iou[i, j] >= IOU_THRESH:
            if not keep_mask[j]:
                flags[i] = -1
            elif not matched[j]:
                matched[j] = True
                flags[i] = 1
    return d[:, 4], flags


def dataset_eval(results: dict, gt: dict, keep: dict) -> float:
    """PR curve over N_THRESH normalized-score thresholds -> AP."""
    all_scores = np.concatenate(
        [r[:, 4] for r in results.values() if r.shape[0]] or [np.zeros(1)]
    )
    smin, smax = float(all_scores.min()), float(all_scores.max())
    span = max(smax - smin, 1e-12)

    npos = sum(int(keep[k].sum()) for k in gt)
    tp = np.zeros(N_THRESH)
    fp = np.zeros(N_THRESH)
    thresh_vec = 1.0 - (np.arange(N_THRESH) + 1) / N_THRESH

    for img, gts in gt.items():
        dets = results.get(img, np.zeros((0, 5)))
        # Official quirk reproduced: images with zero GT boxes are skipped
        # entirely — their detections count as neither TPs nor FPs (the
        # eval_tools main loop `continue`s on empty gt_boxes).
        if dets.shape[0] == 0 or gts.shape[0] == 0:
            continue
        scores, flags = image_eval(dets, gts, keep[img])
        norm = (scores - smin) / span
        # Detections are score-sorted desc; for threshold t, the first
        # `upto[t]` detections count. Accumulate via cumulative TP/FP.
        cum_tp = np.concatenate([[0.0], np.cumsum(flags == 1)])
        cum_fp = np.concatenate([[0.0], np.cumsum(flags == 0)])
        upto = np.searchsorted(-norm, -thresh_vec, side="right")
        tp += cum_tp[upto]
        fp += cum_fp[upto]

    recall = tp / max(npos, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(tp + fp > 0, tp / (tp + fp), 0.0)
    order = np.argsort(recall)
    return voc_ap(recall[order], precision[order])


def gt_from_mats(eval_tools_dir: Path):
    """Exact splits from the official .mat ground-truth files."""
    from scipy.io import loadmat  # type: ignore

    gdir = Path(eval_tools_dir) / "ground_truth"
    base = loadmat(str(gdir / "wider_face_val.mat"))
    settings = {
        name: loadmat(str(gdir / f"wider_{name}_val.mat"))
        for name in ("easy", "medium", "hard")
    }

    gt: dict[str, np.ndarray] = {}
    keep: dict[str, dict[str, np.ndarray]] = {n: {} for n in settings}
    events = base["event_list"]
    files = base["file_list"]
    boxes = base["face_bbx_list"]
    for e in range(events.shape[0]):
        event = str(events[e][0][0])
        for f in range(files[e][0].shape[0]):
            name = str(files[e][0][f][0][0])
            img = f"{event}/{name}.jpg"
            bbx = np.asarray(boxes[e][0][f][0], np.float64).reshape(-1, 4)
            gt[img] = bbx
            for sname, mat in settings.items():
                idx = mat["gt_list"][e][0][f][0]
                k = np.zeros(bbx.shape[0], bool)
                if idx.size:
                    k[np.asarray(idx, int).ravel() - 1] = True  # 1-indexed
                keep[sname][img] = k
    return gt, keep


def gt_from_txt(valdata: str | Path):
    """Overall GT from bbx_gt.txt + approximate height-band splits."""
    samples = parse_wider_annotations(valdata, split="val")
    gt, keep_all, keep_e, keep_m, keep_h = {}, {}, {}, {}, {}
    for s in samples:
        b = s.bboxes
        xywh = np.stack(
            [b[:, 0], b[:, 1], b[:, 2] - b[:, 0] + 1, b[:, 3] - b[:, 1] + 1], 1
        ) if b.shape[0] else np.zeros((0, 4))
        gt[s.img_path] = xywh
        h = xywh[:, 3] if xywh.shape[0] else np.zeros(0)
        valid = np.ones(h.shape[0], bool)
        if s.attrs is not None and len(s.attrs.get("invalid", [])) == h.shape[0]:
            valid = s.attrs["invalid"] == 0
        keep_all[s.img_path] = valid
        keep_e[s.img_path] = valid & (h >= 50)
        keep_m[s.img_path] = valid & (h >= 30)
        keep_h[s.img_path] = valid & (h >= 10)
    return gt, {"all": keep_all, "easy~": keep_e, "medium~": keep_m, "hard~": keep_h}


def main(argv=None):
    parser = argparse.ArgumentParser("WIDER mAP evaluator")
    parser.add_argument("valdata", help="wider_face_val_bbx_gt.txt")
    parser.add_argument("--results-dir", default="val_results")
    parser.add_argument("--eval-tools-dir", default="",
                        help="official eval_tools/ for exact easy/medium/hard")
    parser.add_argument("--out", default="", help="write scores JSON here")
    args = parser.parse_args(argv)

    results = read_results_dir(args.results_dir)
    print(f"{len(results)} result files")

    if args.eval_tools_dir:
        gt, keeps = gt_from_mats(Path(args.eval_tools_dir))
    else:
        gt, keeps = gt_from_txt(args.valdata)
        print("NOTE: exact easy/medium/hard need --eval-tools-dir; "
              "~-suffixed splits are height-band approximations.")

    scores = {}
    for name, keep in keeps.items():
        scores[name] = dataset_eval(results, gt, keep)
        print(f"AP ({name}): {scores[name]:.4f}")

    if args.out:
        # Explicit marker: height-band splits are NOT comparable to the
        # published 0.902/0.892/0.797 official-split numbers.
        payload = {
            "scores": scores,
            "approximate_splits": not bool(args.eval_tools_dir),
            "protocol": "official-mat" if args.eval_tools_dir
            else "height-band-approximation",
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
    return scores


if __name__ == "__main__":
    main()

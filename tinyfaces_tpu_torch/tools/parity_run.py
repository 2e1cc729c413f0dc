"""Published-mAP parity runbook through the port.

    python -m tinyfaces_tpu_torch.tools.parity_run --dataset-root ROOT \\
        --checkpoint checkpoint_50.pth [--eval-tools-dir eval_tools] [--device cuda]

Given mounted WIDER val data and a checkpoint (the reference's released
checkpoint_50.pth, a JAX .npz export or the port's own), this runs the
whole proof chain with no manual steps:

  1. load the weights (evaluation.load_weights: any of the three formats);
  2. optionally A/B the first --ab-images images of the fused pyramid
     against the host-resize path (PIL per level, the reference's
     resampling) and report the max box/score deltas;
  3. evaluate the val split with the fused pyramid (evaluate_model.run);
  4. score the result tree with the port's grader (official .mat splits
     when --eval-tools-dir is given, else height-band approximations) and
     write a scores JSON with pass/fail against the published bars easy
     0.902 / medium 0.892 / hard 0.797 (reference README.md:11-15), judged
     only on official splits.

Smoke mode (--synthetic N) builds an N-image synthetic WIDER tree and runs
the chain with the checkpoint given, or with seeded weights.

The port of tools/parity_run.py, on the port's CLIs and grader; the
wire's `yuv420`/`jpegdct4` exit naming ROADMAP item 15.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tinyfaces_tpu_torch import evaluate_model, wider_eval
from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.data.wider_face import WIDERFace
from tinyfaces_tpu_torch.evaluation import PyramidDetector, get_model

PUBLISHED = {"easy": 0.902, "medium": 0.892, "hard": 0.797}


def build_synthetic_tree(root: Path, n: int, seed: int = 0) -> Path:
    """N-image val tree with WIDER-format annotations (white-box 'faces')."""
    from PIL import Image  # only here: the tree is written as JPEG files

    rng = np.random.default_rng(seed)
    d = root / "WIDER_val" / "images" / "0--Synthetic"
    d.mkdir(parents=True, exist_ok=True)
    ann = []
    for i in range(n):
        h, w = int(rng.integers(300, 700)), int(rng.integers(400, 900))
        img = rng.integers(0, 180, (h, w, 3), dtype=np.uint8)
        k = int(rng.integers(1, 4))
        rows = []
        for _ in range(k):
            bw, bh = int(rng.integers(24, 80)), int(rng.integers(24, 80))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y : y + bh, x : x + bw] = 255
            rows.append(f"{x} {y} {bw} {bh} 0 0 0 0 0 0")
        Image.fromarray(img).save(d / f"im{i}.jpg", quality=92)
        ann += [f"0--Synthetic/im{i}.jpg", str(k)] + rows
    gt = root / "wider_face_split" / "wider_face_val_bbx_gt.txt"
    gt.parent.mkdir(parents=True, exist_ok=True)
    gt.write_text("\n".join(ann) + "\n")
    return gt


def ab_check(detector, dataset, n_images: int, prob_thresh: float,
             nms_thresh: float) -> dict:
    """Fused vs host-resize A/B on the first n_images; returns delta stats."""
    worst = {"count_mismatch": 0, "max_center_delta_px": 0.0,
             "max_score_delta": 0.0, "images": 0}
    for i in range(min(n_images, len(dataset))):
        image, _ = dataset[i]
        fused = detector.detect(image, prob_thresh, nms_thresh)
        hostr = detector.detect(image, prob_thresh, nms_thresh, host_resize=True)
        worst["images"] += 1
        if fused.shape[0] != hostr.shape[0]:
            worst["count_mismatch"] += 1
            continue
        if fused.shape[0] == 0:
            continue
        ca = np.stack([(fused[:, 0] + fused[:, 2]) / 2,
                       (fused[:, 1] + fused[:, 3]) / 2], 1)
        cb = np.stack([(hostr[:, 0] + hostr[:, 2]) / 2,
                       (hostr[:, 1] + hostr[:, 3]) / 2], 1)
        # match by nearest center
        d = np.linalg.norm(ca[:, None] - cb[None, :], axis=2)
        j = d.argmin(axis=1)
        worst["max_center_delta_px"] = max(
            worst["max_center_delta_px"], float(d[np.arange(len(j)), j].max())
        )
        worst["max_score_delta"] = max(
            worst["max_score_delta"],
            float(np.abs(fused[:, 4] - hostr[j, 4]).max()),
        )
    return worst


def arguments(argv=None):
    parser = argparse.ArgumentParser("published-mAP parity runbook")
    parser.add_argument("--dataset-root", default="data/WIDER")
    parser.add_argument("--valdata", default="",
                        help="default <root>/wider_face_split/wider_face_val_bbx_gt.txt")
    parser.add_argument("--checkpoint", default="",
                        help="reference checkpoint_50.pth / JAX .npz export / the port's own")
    parser.add_argument("--eval-tools-dir", default="",
                        help="official eval_tools/ for exact splits")
    parser.add_argument("--out", default="parity_scores.json")
    parser.add_argument("--ab-images", type=int, default=8,
                        help="images to A/B fused vs host-resize (0 = skip)")
    parser.add_argument("--synthetic", type=int, default=0,
                        help="smoke mode: build an N-image synthetic tree")
    parser.add_argument("--prob_thresh", type=float, default=0.03)
    parser.add_argument("--nms_thresh", type=float, default=0.3)
    parser.add_argument("--resample", default="pil", choices=("pil", "linear"),
                        help="fused-sweep level resampling; pil (default) "
                             "= reference-matched PIL bilinear on device")
    parser.add_argument("--template-pruning", default="reference",
                        choices=("reference", "natural"),
                        help="reference = the port's dead-branch pruning "
                             "(parity default); natural = type-B tiny "
                             "templates fire at upsampled scales (Hu's "
                             "MATLAB behavior)")
    parser.add_argument("--transfer", default="rgb",
                        choices=("rgb", "yuv420", "jpegdct", "jpegdct4"),
                        help="wire format for the fused sweep (rgb = bit-exact reference "
                             "input; jpegdct = the production DCT wire; yuv420 and jpegdct4 "
                             "are not ported: ROADMAP item 15)")
    parser.add_argument("--eval-batch", type=int, default=32,
                        help="device batch per shape bucket (see "
                             "evaluate_model.bucket_batch_for)")
    parser.add_argument("--arch", default="resnet101",
                        choices=("resnet101", "resnet50"),
                        help="backbone of the checkpoint being evaluated")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 inference; default fp32 with TF32 off preserves "
                             "reference parity semantics")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = arguments(argv)
    if args.transfer not in ("rgb", "jpegdct"):
        raise SystemExit(f"--transfer {args.transfer} is not ported (ROADMAP item 15)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False; "
                         "pass --device cpu to run on the CPU")
    if not args.bf16:  # fp32 means fp32: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    root = Path(args.dataset_root)
    if args.synthetic:
        print(f"[parity-run] smoke mode: {args.synthetic}-image synthetic tree")
        valdata = build_synthetic_tree(root, args.synthetic)
    else:
        valdata = Path(args.valdata or root / "wider_face_split" / "wider_face_val_bbx_gt.txt")
        if not valdata.exists():
            sys.exit(f"[parity-run] no val annotations at {valdata} — mount "
                     f"WIDER under {root} or pass --valdata/--synthetic")

    templates = load_templates()
    cfg = DetectorConfig()
    print(f"[parity-run] 1/4 loading checkpoint "
          f"{args.checkpoint or '(seeded weights — smoke only)'}")
    model = get_model(args.checkpoint or None, num_templates=templates.shape[0],
                      dtype=torch.bfloat16 if args.bf16 else torch.float32, arch=args.arch,
                      device=device)
    # resample="pil": the fused sweep runs the reference's PIL-bilinear
    # resampling (ops/pilresize.py) — the A/B below then compares two
    # implementations of the same kernel.
    detector = PyramidDetector(model, templates, cfg=cfg,
                               ec=EvalConfig(resample=args.resample,
                                             template_pruning=args.template_pruning),
                               device=device, transfer=args.transfer)

    dataset = WIDERFace(valdata, templates, cfg=cfg, dataset_root=root, split="val")
    results_dir = Path("parity_val_results")
    if results_dir.exists():
        # stale result files from a previous run (other checkpoint / smoke
        # tree) would enter the evaluator's global score normalization and
        # corrupt the PASS/FAIL verdict
        shutil.rmtree(results_dir)

    ab = None
    if args.ab_images:
        print(f"[parity-run] 2/4 fused-vs-host-resize A/B on {args.ab_images} images")
        ab = ab_check(detector, dataset, args.ab_images, args.prob_thresh, args.nms_thresh)
        print(f"[parity-run]    {ab}")

    print(f"[parity-run] 3/4 evaluating {len(dataset)} val images")
    t0 = time.time()
    evaluate_model.run(detector, dataset, args.prob_thresh, args.nms_thresh,
                       "val", results_dir=results_dir, eval_batch=args.eval_batch)
    rate = len(dataset) / (time.time() - t0)
    phases = evaluate_model.run.last_phases or {}
    steady = phases.get("images_per_sec_steady")
    print(f"[parity-run]    {rate:.2f} img/s"
          + (f" ({steady:.2f} after the first batch settles)" if steady else ""))

    print("[parity-run] 4/4 scoring")
    results = wider_eval.read_results_dir(results_dir)
    if args.eval_tools_dir:
        gt, keeps = wider_eval.gt_from_mats(Path(args.eval_tools_dir))
        official = True
    else:
        gt, keeps = wider_eval.gt_from_txt(valdata)
        official = False
        print("[parity-run] NOTE: approximate height-band splits — NOT "
              "comparable to the published bars; pass --eval-tools-dir "
              "for the official protocol.")

    scores = {}
    for name, keep in keeps.items():
        scores[name] = wider_eval.dataset_eval(results, gt, keep)
        print(f"[parity-run] AP({name}) = {scores[name]:.4f}")

    verdict = {}
    if official:
        for split, bar in PUBLISHED.items():
            got = scores.get(split)
            verdict[split] = {"ap": got, "published": bar,
                              "pass": bool(got is not None and got >= bar - 0.005)}
        ok = all(v["pass"] for v in verdict.values())
        print(f"[parity-run] VERDICT: {'PASS' if ok else 'FAIL'} vs "
              f"published 0.902/0.892/0.797")
    payload = {
        "scores": scores,
        "official_splits": official,
        "approximate_splits": not official,
        "published_bars": PUBLISHED,
        "verdict": verdict or None,
        "ab_check": ab,
        "images": len(dataset),
        "images_per_sec": rate,
        "images_per_sec_steady": steady,
        "first_fetch_s": phases.get("first_fetch"),
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "checkpoint": str(args.checkpoint),
        "synthetic_smoke": bool(args.synthetic),
        "transfer": args.transfer,
        "resample": args.resample,
        "bf16": bool(args.bf16),
        "template_pruning": args.template_pruning,
    }
    Path(args.out).write_text(json.dumps(payload, indent=1))
    print(f"[parity-run] wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()

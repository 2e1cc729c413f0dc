"""Closed-loop trained-model accuracy through the port's CLIs.

    python -m tinyfaces_tpu_torch.tools.e2e_accuracy [--workdir DIR] [--device cuda]
    python -m tinyfaces_tpu_torch.tools.e2e_accuracy --device cpu --arch resnet50 \\
        --train-images 24 --val-images 4 --epochs 1      # the harness at a tiny size

Real WIDER data and released weights are not needed: the loop closes on
synthetic WIDER-format data with learnable painted faces, and every stage
is the production code path:

  1. a train tree (train_soak.paint_faces, seed 0) -> `python -m
     tinyfaces_tpu_torch.main` for --epochs: the real CLI, loader, Trainer,
     K1 on every step, per-epoch checkpoint (optionally SIGTERM during
     --sigterm-epoch and --resume from the emergency checkpoint);
  2. a held-out val tree (the same face distribution, seed 4242, images
     pinned to 768x1024, one canvas bucket) -> parity_run with the trained
     checkpoint: the fused pyramid on the production configuration, the
     jpegdct wire, bf16, eval batch 32;
  3. the port's grader scores the result tree (approximate height-band
     splits: synthetic data has no official .mat), recall_bands splits the
     recall by GT height;
  4. <workdir>/E2E_ACCURACY.json (or --out): steps, loss first/last windows
     and per epoch, AP per split, recall by height, train and eval rates,
     the K1 launches the training runs report, the device.

The port of tools/e2e_accuracy.py; `--cpu` is `--device cpu` here, and the
train wire `yuv420` exits naming ROADMAP item 15.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from tinyfaces_tpu_torch.tools.recall_bands import recall_bands
from tinyfaces_tpu_torch.tools.train_soak import (check_transfer, child_env, kernel_launches,
                                                  make_wider_tree, parse_metrics, run_main,
                                                  step_loss, write_split)


def make_val_tree(root: Path, n_images: int, seed: int,
                  size: tuple[int, int] = (768, 1024),
                  distribution: str = "hard") -> Path:
    """Held-out WIDER val split from the same face distribution as the
    train tree (paint_faces), at a fixed canvas size: 768x1024 is its own
    shape bucket, so the whole sweep runs at one batch shape."""
    return write_split(root, "WIDER_val", "wider_face_val_bbx_gt.txt", "val",
                       np.random.default_rng(seed), n_images, lambda rng: size, distribution)


def train(args, tree: Path, workdir: Path, ckpt: Path) -> tuple[list, dict | None, int | None]:
    """The train leg: (metrics rows, resume-seam record or None, K1
    launches the runs report, None when reusing a checkpoint)."""
    metrics = workdir / "metrics.jsonl"
    common = ["--arch", args.arch, "--save-every", str(args.epochs)]
    if args.skip_train and ckpt.exists():
        print(f"[e2e] --skip-train: reusing {ckpt}", flush=True)
        return parse_metrics(metrics), None, None
    steps_per_epoch = args.train_images // args.batch
    if args.sigterm_epoch < 0:
        print(f"[e2e] training {args.epochs} epochs x {steps_per_epoch} steps…", flush=True)
        metrics.unlink(missing_ok=True)
        rc, log = run_main(tree, workdir, metrics, args.epochs, args.batch, common,
                           device=args.device, transfer=args.train_transfer)
        if rc != 0:
            raise RuntimeError(f"the training CLI failed rc={rc}; see {workdir}")
        if not ckpt.exists():
            raise RuntimeError(f"no final checkpoint at {ckpt}")
        return parse_metrics(metrics), None, kernel_launches(log)

    # Full-schedule protocol: run 1 -> SIGTERM mid-schedule -> emergency
    # checkpoint -> run 2 --resume to the end. Metrics from both runs are
    # merged (and copied to metrics.jsonl for --skip-train reruns).
    m1, m2 = workdir / "metrics_run1.jsonl", workdir / "metrics_run2.jsonl"
    m1.unlink(missing_ok=True)
    m2.unlink(missing_ok=True)
    print(f"[e2e] training {args.epochs} epochs x {steps_per_epoch} steps, SIGTERM during "
          f"epoch {args.sigterm_epoch}…", flush=True)
    rc1, log1 = run_main(tree, workdir, m1, args.epochs, args.batch, common,
                         sigterm_epoch=args.sigterm_epoch, device=args.device,
                         transfer=args.train_transfer)
    ckpts = sorted((workdir / "weights").glob("checkpoint_*"),
                   key=lambda p: int(p.name.split("_")[1]))
    if not ckpts:
        raise RuntimeError(f"no emergency checkpoint (rc={rc1}); see {workdir}")
    resume = ckpts[-1]
    print(f"[e2e] resuming from {resume.name}…", flush=True)
    rc2, log2 = run_main(tree, workdir, m2, args.epochs, args.batch,
                         [*common, "--resume", str(resume)], device=args.device,
                         transfer=args.train_transfer)
    if rc2 != 0:
        raise RuntimeError(f"resume run failed rc={rc2}; see {workdir}")
    if not ckpt.exists():
        raise RuntimeError(f"no final checkpoint at {ckpt}")
    rows1, rows2 = parse_metrics(m1), parse_metrics(m2)
    s1 = [r for r in rows1 if r.get("event") != "epoch_end"]
    s2 = [r for r in rows2 if r.get("event") != "epoch_end"]
    seam = {
        "sigterm_epoch": args.sigterm_epoch,
        "emergency_checkpoint": resume.name,
        "resumed_at_epoch": s2[0]["epoch"] if s2 else None,
        "seam_loss_ratio": round(float(np.mean([step_loss(r) for r in s2[:3]])
                                       / max(np.mean([step_loss(r) for r in s1[-3:]]), 1e-9)), 3)
        if s1 and s2 else None,
    }
    rows = rows1 + rows2
    metrics.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return rows, seam, kernel_launches(log1) + kernel_launches(log2)


def evaluate(args, tree: Path, workdir: Path, ckpt: Path) -> dict:
    """The eval leg in a child process: parity_run with the production
    configuration (jpegdct, bf16, linear resampling). Returns its JSON."""
    scores_json = workdir / "parity_scores.json"
    cmd = [sys.executable, "-m", "tinyfaces_tpu_torch.tools.parity_run",
           "--dataset-root", str(tree), "--checkpoint", str(ckpt), "--arch", args.arch,
           "--ab-images", "0", "--resample", "linear", "--transfer", "jpegdct", "--bf16",
           "--prob_thresh", str(args.prob_thresh), "--eval-batch", str(args.eval_batch),
           "--out", str(scores_json), "--device", args.device]
    log_path = workdir / "parity_run.log"
    with open(log_path, "w") as lf:
        rc = subprocess.run(cmd, cwd=workdir, stdout=lf, stderr=subprocess.STDOUT,
                            env=child_env()).returncode
    if rc != 0:
        raise RuntimeError(f"parity_run failed rc={rc}; see {log_path}")
    return json.loads(scores_json.read_text())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train-images", type=int, default=1200)
    ap.add_argument("--val-images", type=int, default=192)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "e2e_accuracy"))
    ap.add_argument("--out", default="", help="default <workdir>/E2E_ACCURACY.json")
    ap.add_argument("--arch", default="resnet101")
    ap.add_argument("--prob-thresh", type=float, default=0.03)
    ap.add_argument("--eval-batch", type=int, default=32)
    ap.add_argument("--val-size", default="768x1024",
                    help="fixed val canvas HxW; 768x1024 (default) is one canvas bucket")
    ap.add_argument("--device", default="cuda", help="device of the child runs (cuda or cpu)")
    ap.add_argument("--skip-train", action="store_true",
                    help="reuse the checkpoint already in workdir/weights")
    ap.add_argument("--sigterm-epoch", type=int, default=-1,
                    help="SIGTERM the first training run during this epoch and resume "
                         "from the emergency checkpoint (e.g. --epochs 50 --sigterm-epoch "
                         "22 crosses the epoch-20 StepLR decay, seams mid-schedule, and "
                         "crosses epoch 40 in the resumed run)")
    ap.add_argument("--train-transfer", default="rgb", choices=("yuv420", "rgb", "jpegdct"),
                    help="train input wire passed to main --transfer (jpegdct = device-side "
                         "decode and augmentation; yuv420 is not ported: ROADMAP item 15); "
                         "the eval leg always uses the production jpegdct wire")
    ap.add_argument("--distribution", default="hard", choices=("hard", "easy"),
                    help="painted-face distribution (hard = WIDER-like small-face tail + "
                         "crowds; easy = fewer, larger faces)")
    args = ap.parse_args(argv)
    check_transfer(args.train_transfer)

    workdir = Path(args.workdir).resolve()  # the children run in it
    workdir.mkdir(parents=True, exist_ok=True)
    tree = workdir / "wider"
    marker = tree / (f".gen_{args.train_images}_{args.val_images}"
                     f"_{args.val_size.lower()}_{args.distribution}")
    if not marker.exists():
        print(f"[e2e] generating {args.train_images}-image train + {args.val_images}-image "
              f"val trees ({args.distribution})…", flush=True)
        vh, vw = (int(v) for v in args.val_size.lower().split("x"))
        make_wider_tree(tree, args.train_images, seed=0, distribution=args.distribution)
        make_val_tree(tree, args.val_images, seed=4242, size=(vh, vw),
                      distribution=args.distribution)
        marker.touch()

    t_start = time.time()
    ckpt = workdir / "weights" / f"checkpoint_{args.epochs}"
    rows, seam, launches = train(args, tree, workdir, ckpt)
    steps = [r for r in rows if r.get("event") != "epoch_end"]
    train_hours = (time.time() - t_start) / 3600

    print(f"[e2e] evaluating {args.val_images} held-out images with {ckpt.name}…", flush=True)
    scores = evaluate(args, tree, workdir, ckpt)

    first = [step_loss(r) for r in steps[:3]]
    last = [step_loss(r) for r in steps[-3:]]
    by_epoch: dict = {}
    for r in steps:
        by_epoch.setdefault(r["epoch"], []).append(step_loss(r))
    curve = [round(float(np.mean(v)), 2) for _, v in sorted(by_epoch.items())]
    aps = scores["scores"]
    bands = recall_bands(workdir / "parity_val_results",
                         tree / "wider_face_split" / "wider_face_val_bbx_gt.txt")
    rates = [r["images_per_sec"] for r in rows
             if r.get("event") == "epoch_end" and r.get("images_per_sec")]
    result = {
        "train_images": args.train_images,
        "val_images": args.val_images,
        "total_steps": (args.train_images // args.batch) * args.epochs,
        "batch_size": args.batch,
        "arch": args.arch,
        "train_transfer": args.train_transfer,
        "face_distribution": args.distribution,
        "loss_cls_first_window": round(float(np.mean(first)), 3) if first else None,
        "loss_cls_last_window": round(float(np.mean(last)), 3) if last else None,
        "loss_cls_per_epoch": curve,
        "resume_seam": seam,
        "k1_launches": launches,
        "train_images_per_sec": {"median": float(np.median(rates)), "min": float(np.min(rates)),
                                 "max": float(np.max(rates))} if rates else None,
        "ap": {k: float(v) for k, v in aps.items()},
        "recall_by_height": bands,
        "splits": "approximate height-band (synthetic data; no official .mat)",
        "eval_images_per_sec": scores.get("images_per_sec"),
        "eval_images_per_sec_steady": scores.get("images_per_sec_steady"),
        "eval_first_fetch_s": scores.get("first_fetch_s"),
        "eval_config": {"transfer": "jpegdct", "bf16": True, "resample": "linear",
                        "prob_thresh": args.prob_thresh, "eval_batch": args.eval_batch,
                        "val_size": args.val_size},
        "wall_hours": round((time.time() - t_start) / 3600, 4),
        "train_hours": round(train_hours, 4),
        "device": scores.get("device"),
        "learned": bool(aps and max(aps.values()) > 0.5),
    }
    out = Path(args.out or workdir / "E2E_ACCURACY.json")
    out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()

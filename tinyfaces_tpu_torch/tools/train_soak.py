"""Training soak through the port's CLI, and the synthetic WIDER trees that
the closed-loop accuracy tools share.

    python -m tinyfaces_tpu_torch.tools.train_soak --images 1200 --epochs 24 \\
        --sigterm-epoch 9 [--workdir DIR] [--device cuda]

1. Generates a synthetic WIDER-format tree (JPEG images + annotation txt,
   painted "faces" the random-init model can actually learn to score).
2. Runs `python -m tinyfaces_tpu_torch.main` (the real CLI: parser, loader
   factory, Trainer, K1 on every step) for `--epochs`, sends SIGTERM during
   `--sigterm-epoch`, and checks that the emergency checkpoint lands at the
   epoch boundary.
3. Resumes with `--resume <ckpt>` to the full epoch budget; checks that the
   step counter and loss continue (no reset, no jump).
4. Writes `<workdir>/TRAIN_SOAK.json` (or `--out`): steps, loss first/last
   windows, images/sec per epoch, GT-overflow reports, non-finite steps and
   the K1 launches the child runs report.

The port of tools/train_soak.py. PIL is imported only where a JPEG is
written; the train wire defaults to `yuv420`, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
TRANSFERS = ("rgb", "yuv420", "jpegdct")
_LAUNCHES = re.compile(r"^kernel launches: dense_assignment_reductions (\d+)$", re.M)


def check_transfer(transfer: str) -> str:
    if transfer not in TRANSFERS:
        raise SystemExit(f"unknown --transfer {transfer}; choose one of {TRANSFERS}")
    return transfer


def child_env() -> dict:
    """The environment of a child CLI: this checkout first on the import
    path (children run in their work directory), output unbuffered."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(REPO), env.get("PYTHONPATH", "")) if p)
    env["PYTHONUNBUFFERED"] = "1"
    return env


def paint_faces(rng: np.random.Generator, h: int, w: int,
                distribution: str = "hard"):
    """One synthetic photo with painted face-like blobs (bright ellipse on
    darker head-box) over a textured background. Returns (uint8 HxWx3
    image, [(x, y, w, h), ...]) — a consistent local pattern the detector
    templates can latch onto, shared by the train soak and the e2e
    accuracy harness so train/val draws come from the same distribution.

    distribution="hard" (default): WIDER-like scale spread —
    lognormal(2.9, 0.9) clipped to [10, 200] px (median ~18 px, heavy
    small-face tail like WIDER hard) — plus 25% "crowd" images with an
    extra 15-45 small (10-36 px) faces in a jittered cluster, and faces may
    overlap (larger painted first, so small faces partially occlude big
    ones). "easy": 2-14 faces, lognormal(3.2, 0.8) in [8, 160], painted in
    draw order."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (96 + 50 * np.sin(xx / rng.uniform(40, 140))
           + 40 * np.cos(yy / rng.uniform(30, 120)))[..., None]
    img = img + rng.normal(0, 12, (h, w, 3))

    def _paint(x, y, s):
        box = (slice(y, y + s), slice(x, x + s))
        img[box] = img[box] * 0.4 + 60
        cy, cx, r = y + s / 2, x + s / 2, s / 2.2
        # The disc (radius s/2.2 about the box's centre) lies inside the
        # box, so the mask is computed over the box alone: the same pixels
        # as over the whole image, at a fraction of the cost.
        mask = ((yy[box] - cy) ** 2 + (xx[box] - cx) ** 2) < r * r
        img[box][mask] = [225, 185, 160]

    boxes = []
    if distribution == "easy":
        n_faces = int(rng.integers(2, 15))
        for _ in range(n_faces):
            s = int(np.clip(rng.lognormal(3.2, 0.8), 8, 160))
            x = int(rng.integers(0, max(1, w - s)))
            y = int(rng.integers(0, max(1, h - s)))
            _paint(x, y, s)
            boxes.append((x, y, s, s))
    else:
        sizes = [int(np.clip(rng.lognormal(2.9, 0.9), 10, 200))
                 for _ in range(int(rng.integers(2, 15)))]
        if rng.random() < 0.25:  # crowd: cluster of small faces
            k = int(rng.integers(15, 46))
            ccx = rng.integers(0, max(1, w - 200))
            ccy = rng.integers(0, max(1, h - 200))
            crowd = []
            for _ in range(k):
                s = int(rng.integers(10, 37))
                x = int(np.clip(ccx + rng.normal(100, 70), 0, max(1, w - s)))
                y = int(np.clip(ccy + rng.normal(100, 70), 0, max(1, h - s)))
                crowd.append((x, y, s))
            sizes_xy = crowd
        else:
            sizes_xy = []
        placed = [(int(rng.integers(0, max(1, w - s))),
                   int(rng.integers(0, max(1, h - s))), s) for s in sizes]
        placed += sizes_xy
        # paint big -> small so small faces stay visible (occlusion)
        for x, y, s in sorted(placed, key=lambda t: -t[2]):
            _paint(x, y, s)
            boxes.append((x, y, s, s))
    return np.clip(img, 0, 255).astype(np.uint8), boxes


def write_split(root: Path, split_dir: str, ann_name: str, prefix: str, rng,
                n_images: int, draw_hw, distribution: str) -> Path:
    """Paint n_images images of size draw_hw(rng) into
    root/split_dir/images/0--Soak/, save each as JPEG q88 and write the
    WIDER-format annotation file root/wider_face_split/ann_name."""
    from PIL import Image  # only here: the trees are written as JPEG files

    d = root / split_dir / "images" / "0--Soak"
    d.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n_images):
        h, w = draw_hw(rng)
        img, boxes = paint_faces(rng, h, w, distribution)
        name = f"{prefix}_{i:05d}.jpg"
        Image.fromarray(img).save(d / name, quality=88)
        lines.append(f"0--Soak/{name}")
        lines.append(str(len(boxes)))
        lines.extend(f"{x} {y} {bw} {bh} 0 0 0 0 0 0" for x, y, bw, bh in boxes)
    sd = root / "wider_face_split"
    sd.mkdir(exist_ok=True)
    ann = sd / ann_name
    ann.write_text("\n".join(lines) + "\n")
    return ann


def make_wider_tree(root: Path, n_images: int, seed: int = 0,
                    distribution: str = "hard") -> Path:
    """Synthetic WIDER train split built from paint_faces images of
    420-759 x 520-999 px. Returns the annotation file."""
    def draw_hw(rng):
        return int(rng.integers(420, 760)), int(rng.integers(520, 1000))

    return write_split(root, "WIDER_train", "train.txt", "soak", np.random.default_rng(seed),
                       n_images, draw_hw, distribution)


def run_main(tree: Path, workdir: Path, metrics: Path, epochs: int,
             batch: int, extra: list[str], sigterm_epoch: int = -1,
             timeout_s: int = 14400, device: str = "cuda",
             transfer: str = "yuv420") -> tuple[int, str]:
    """Run the port's training CLI as a child process in `workdir`
    (checkpoints land in workdir/weights). If sigterm_epoch >= 0, SIGTERM
    the child the first time its log shows that epoch training — the
    emergency checkpoint path. Returns (exit code, log)."""
    cmd = [sys.executable, "-m", "tinyfaces_tpu_torch.main",
           str(tree / "wider_face_split" / "train.txt"), "unused-val",
           "--dataset-root", str(tree), "--epochs", str(epochs),
           "--batch_size", str(batch), "--workers", "8",
           "--log-every", "20", "--metrics-log", str(metrics),
           "--transfer", check_transfer(transfer), "--nan-guard", "--save-every", "1000",
           "--device", device, *extra]
    log_path = workdir / f"main_e{epochs}{'_sig' if sigterm_epoch >= 0 else ''}.log"
    with open(log_path, "w") as lf:
        proc = subprocess.Popen(cmd, cwd=workdir, stdout=lf,
                                stderr=subprocess.STDOUT, env=child_env())
        try:
            t0 = time.time()
            sent = False
            while proc.poll() is None:
                if time.time() - t0 > timeout_s:
                    raise TimeoutError(f"the training CLI exceeded {timeout_s}s; see {log_path}")
                if sigterm_epoch >= 0 and not sent:
                    if f"Epoch: [{sigterm_epoch}]" in log_path.read_text():
                        proc.send_signal(signal.SIGTERM)
                        sent = True
                        print(f"[soak] SIGTERM sent during epoch {sigterm_epoch}", flush=True)
                time.sleep(1)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return proc.returncode, log_path.read_text()


def parse_metrics(path: Path) -> list[dict]:
    rows = []
    if path.exists():
        for line in path.read_text().splitlines():
            if line.strip():
                rows.append(json.loads(line))
    return rows


def kernel_launches(log: str) -> int:
    """K1 launches that the training CLI reports at its end (0 if the log
    holds no such line, e.g. a run that failed)."""
    return sum(int(n) for n in _LAUNCHES.findall(log))


def step_loss(row: dict) -> float:
    """The instantaneous per-step loss; the console `loss_cls` is the
    reference's never-reset running average."""
    return row.get("loss_cls_step") or row["loss_cls"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=1200)
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--sigterm-epoch", type=int, default=-1,
                    help="epoch during which to SIGTERM the first run "
                         "(default: 40%% of --epochs)")
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--workdir", default=str(Path(tempfile.gettempdir()) / "train_soak"))
    ap.add_argument("--out", default="", help="default <workdir>/TRAIN_SOAK.json")
    ap.add_argument("--device", default="cuda", help="device of the child runs (cuda or cpu)")
    ap.add_argument("--arch", default="resnet101")
    ap.add_argument("--transfer", default="yuv420", choices=TRANSFERS,
                    help="train-input wire (main --transfer)")
    args = ap.parse_args(argv)
    check_transfer(args.transfer)
    sig_epoch = (args.sigterm_epoch if args.sigterm_epoch >= 0
                 else max(1, int(args.epochs * 0.4)))

    workdir = Path(args.workdir).resolve()  # the children run in it
    workdir.mkdir(parents=True, exist_ok=True)
    tree = workdir / "wider"
    marker = tree / f".gen_{args.images}"
    if not marker.exists():
        print(f"[soak] generating {args.images}-image WIDER tree…", flush=True)
        make_wider_tree(tree, args.images)
        marker.touch()

    t_start = time.time()
    metrics1 = workdir / "metrics_run1.jsonl"
    metrics1.unlink(missing_ok=True)

    print(f"[soak] run 1: epochs 0..{args.epochs}, SIGTERM during epoch "
          f"{sig_epoch}", flush=True)
    rc1, log1 = run_main(tree, workdir, metrics1, args.epochs, args.batch,
                         ["--arch", args.arch], sigterm_epoch=sig_epoch,
                         device=args.device, transfer=args.transfer)
    ckpts = sorted((workdir / "weights").glob("checkpoint_*"),
                   key=lambda p: int(p.name.split("_")[1]))
    if not ckpts:
        raise RuntimeError(f"no emergency checkpoint written (rc={rc1}); see workdir")
    resume_ckpt = ckpts[-1]
    resume_epoch = int(resume_ckpt.name.split("_")[1])
    rows1 = parse_metrics(metrics1)
    steps1 = [r for r in rows1 if r.get("event") != "epoch_end"]
    if resume_epoch < sig_epoch:
        raise RuntimeError(f"emergency checkpoint at epoch {resume_epoch} predates the "
                           f"signal epoch {sig_epoch}")
    print(f"[soak] run 1 done rc={rc1}; emergency checkpoint "
          f"{resume_ckpt.name}; {len(steps1)} logged steps", flush=True)

    metrics2 = workdir / "metrics_run2.jsonl"
    metrics2.unlink(missing_ok=True)
    print(f"[soak] run 2: --resume {resume_ckpt.name} to epoch {args.epochs}", flush=True)
    rc2, log2 = run_main(tree, workdir, metrics2, args.epochs, args.batch,
                         ["--arch", args.arch, "--resume", str(resume_ckpt)],
                         device=args.device, transfer=args.transfer)
    rows2 = parse_metrics(metrics2)
    steps2 = [r for r in rows2 if r.get("event") != "epoch_end"]
    epochs2 = [r for r in rows2 if r.get("event") == "epoch_end"]
    if rc2 != 0:
        raise RuntimeError(f"resume run failed rc={rc2}")
    if not steps2 or steps2[0]["epoch"] != resume_epoch:
        raise RuntimeError(f"resume did not continue from epoch {resume_epoch}: {steps2[:1]}")

    # Loss continuity across the resume seam, on instantaneous losses.
    pre = [step_loss(r) for r in steps1[-3:]]
    post = [step_loss(r) for r in steps2[:3]]
    seam_ratio = float(np.mean(post) / max(np.mean(pre), 1e-9))

    ips1 = [r["images_per_sec"] for r in rows1 if r.get("event") == "epoch_end"]
    ips2 = [r["images_per_sec"] for r in epochs2]
    ips = [v for v in ips1 + ips2 if v]
    first_losses = [step_loss(r) for r in steps1[:3]]
    last_losses = [step_loss(r) for r in steps2[-3:]]
    steps_per_epoch = args.images // args.batch
    total_steps = steps_per_epoch * args.epochs
    nonfinite = log1.count("non-finite loss") + log2.count("non-finite loss")
    gt_lines = [ln for ln in (log1 + log2).splitlines() if "GT truncation" in ln]

    result = {
        "total_steps": total_steps,
        "steps_per_epoch": steps_per_epoch,
        "batch_size": args.batch,
        "transfer": args.transfer,
        "device": args.device,
        "wall_hours": round((time.time() - t_start) / 3600, 2),
        "loss_cls_first_window": round(float(np.mean(first_losses)), 3),
        "loss_cls_last_window": round(float(np.mean(last_losses)), 3),
        "images_per_sec_median": round(float(np.median(ips)), 1) if ips else None,
        "images_per_sec_min": round(float(np.min(ips)), 1) if ips else None,
        "images_per_sec_max": round(float(np.max(ips)), 1) if ips else None,
        "epoch_rates": [round(v, 1) for v in ips],
        "sigterm_epoch": sig_epoch,
        "emergency_checkpoint": resume_ckpt.name,
        "resume_seam_loss_ratio": round(seam_ratio, 3),
        "resume_continued_at_epoch": steps2[0]["epoch"],
        "nonfinite_steps": nonfinite,
        "gt_truncation_reports": gt_lines[-1:] or ["none"],
        "k1_launches": kernel_launches(log1) + kernel_launches(log2),
        "descended": bool(np.mean(last_losses) < np.mean(first_losses)),
        "seam_ok": bool(0.5 < seam_ratio < 2.0),
    }
    out = Path(args.out or workdir / "TRAIN_SOAK.json")
    out.write_text(json.dumps(result, indent=1) + "\n")
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()

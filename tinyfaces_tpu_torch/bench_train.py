"""Benchmark: training-step throughput on one card.

    python -m tinyfaces_tpu_torch.bench_train [--device cuda]

Port of the root bench_train.py. It measures `Trainer.train_step` —
normalization, the GT assignment (K1, the CUDA kernel), ResNet-101 forward
and backward, the per-group SGD update — at the reference schedule (batch
12, 500x500, fp32 with TF32 off), the upload of each batch included. Every
timed step takes a distinct batch staged in pinned host memory beforehand,
so host packing stays out of the windows. The result is the median of
WINDOWS windows of STEPS_PER_WINDOW steps.

Knobs: BENCH_BATCH (12); BENCH_DTYPE=bf16 (bf16 activations, fp32
parameters and optimizer, TF32 allowed); BENCH_TRANSFER=rgb (the default),
yuv420 (the JAX bench's default: planar YCbCr 4:2:0, converted on the card
inside the step) or jpegdct (the coefficients of a synthetic JPEG,
augmented on the card, data/dct_train.py; PIL writes the JPEG).

Prints ONE JSON line last on stdout: {"metric", "value", "unit",
"vs_baseline"}. On stderr: the card's name and power limit, warm-up
seconds, the window rates, the last loss, K1's launches, peak memory and
the achieved TFLOP/s (tools.profile_model).

Baseline: the reference publishes no train throughput (BASELINE.md); we use
a FLOPs-derived estimate of its PyTorch loop on an A100: ~0.77 TFLOP/image
fwd+bwd at 500x500 + the serial NumPy target generation that dominates its
step (SURVEY.md §2.4) ≈ 18 img/s sustained. vs_baseline = ours / 18.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES

BASELINE_IMGS_PER_SEC = 18.0  # estimated reference-on-A100 (docstring)
METRIC = "train_step_images_per_sec_per_chip"
WINDOWS = 5
STEPS_PER_WINDOW = 8
TRANSFERS = ("rgb", "yuv420", "jpegdct")


def make_synthetic_train_batch(rng, batch: int, cfg, n_boxes: int = 40) -> dict:
    """Synthetic WIDER-like train batch (500x500 canvas, n_boxes GT faces)
    in the schema the Trainer consumes, as NumPy arrays. Draw order is part
    of the contract: the same rng gives the root bench_train.py's batches."""
    x1 = rng.uniform(0, 420, (batch, n_boxes)).astype(np.float32)
    y1 = rng.uniform(0, 420, (batch, n_boxes)).astype(np.float32)
    gt = np.zeros((batch, cfg.max_gt, 4), np.float32)
    gt[:, :n_boxes, 0] = x1
    gt[:, :n_boxes, 1] = y1
    gt[:, :n_boxes, 2] = x1 + rng.uniform(8, 80, (batch, n_boxes))
    gt[:, :n_boxes, 3] = y1 + rng.uniform(8, 80, (batch, n_boxes))
    valid = np.zeros((batch, cfg.max_gt), bool)
    valid[:, :n_boxes] = True
    return {
        "image": rng.integers(0, 255, (batch, 500, 500, 3), dtype=np.uint8),
        "gt_boxes": gt,
        "gt_valid": valid,
        "paste_box": np.tile(np.array([0, 0, 500, 500], np.float32), (batch, 1)),
        "flip": rng.random(batch) > 0.5,
    }


def jpegdct_packer(rng, batch: int, cfg):
    """The jpegdct wire's batches: one natural-statistics synthetic JPEG
    (q88) entropy-decoded once, 40 boxes drawn from `rng`, and per batch
    `batch` fresh augmentations of it (data/dct_train.train_item_dct),
    drawn as the JAX bench draws them. Returns pack(rgb_batch) -> batch."""
    from tinyfaces_tpu_torch.data.dct_train import decode_dct, train_item_dct
    from tinyfaces_tpu_torch.utils.instruments import jpeg_bytes

    yy, xx = np.mgrid[0:560, 0:740]
    img = np.clip(
        (128 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0))[..., None]
        + rng.normal(0, 10, (560, 740))[..., None] * np.ones(3),
        0, 255).astype(np.uint8)
    dct = decode_dct(jpeg_bytes([img], quality=88, subsampling=-1)[0])
    bx1 = rng.uniform(0, 420, 40).astype(np.float32)
    by1 = rng.uniform(0, 420, 40).astype(np.float32)
    boxes = np.stack(
        [bx1, by1, bx1 + rng.uniform(8, 80, 40).astype(np.float32),
         by1 + rng.uniform(8, 80, 40).astype(np.float32)], -1)
    seed_box = [0]

    def pack(_):
        items = []
        for _ in range(batch):
            seed_box[0] += 1
            items.append(train_item_dct(dct, boxes.copy(), cfg, np.random.default_rng(seed_box[0])))
        out = {k: np.stack([it[k] for it in items]) for k in items[0]}
        out["flip"] = np.array([it["flip"] for it in items])
        return out

    return pack


def pinned(batch: dict, dev: torch.device) -> dict:
    """NumPy batch -> host tensors, pinned when the device is a card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = t.pin_memory() if dev.type == "cuda" else t
    return out


def run(trainer, host_batches: Sequence[dict], *, windows: int, steps_per_window: int) -> dict:
    """Warm-up on host_batches[0], then `windows` windows of
    `steps_per_window` steps, each step on the next distinct batch
    (uploaded with non_blocking); img/s per window, device synchronised at
    each window's end. `k1_launches` counts every step's, the warm-up's
    too."""
    from tinyfaces_tpu_torch.utils import graphs
    from tinyfaces_tpu_torch.utils.instruments import peak_gib, reset_peak, sync

    dev = torch.device(trainer.device)
    batch = host_batches[0]["gt_boxes"].shape[0]

    def step(host):
        return trainer.train_step({k: v.to(dev, non_blocking=True) for k, v in host.items()})

    launches0 = graphs.launches("k1")
    t0 = time.perf_counter()
    lb = step(host_batches[0])
    first_loss = float(lb.total)
    warmup_s = time.perf_counter() - t0
    reset_peak(dev)
    rates = []
    for w in range(windows):
        t0 = time.perf_counter()
        for i in range(steps_per_window):
            lb = step(host_batches[1 + w * steps_per_window + i])
        sync(dev)
        rates.append(batch * steps_per_window / (time.perf_counter() - t0))
    steps = windows * steps_per_window
    return {"value": float(np.median(rates)), "window_rates": rates, "warmup_s": warmup_s,
            "first_loss": first_loss, "last_loss": float(lb.total), "steps": steps,
            "k1_launches": graphs.launches("k1") - launches0, "peak_gib": peak_gib(dev)}


def yuv420_pack(b: dict) -> dict:
    """A synthetic batch on the yuv420 wire, as the root bench_train.py packs it."""
    from tinyfaces_tpu_torch.data.targets import rgb_to_yuv420

    b = dict(b)
    y, u, v = rgb_to_yuv420(b.pop("image"))
    return {**b, "image_y": y, "image_u": u, "image_v": v}


def result_line(value: float) -> dict:
    return {"metric": METRIC, "value": round(value, 3), "unit": "images/sec/chip",
            "vs_baseline": round(value / BASELINE_IMGS_PER_SEC, 3)}


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES) -> dict:
    """The CLI. `stage_sizes` is the published ResNet-101; only tests
    shrink it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig
    from tinyfaces_tpu_torch.data import load_templates
    from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
    from tinyfaces_tpu_torch.tools.profile_model import achieved, train_step_flops
    from tinyfaces_tpu_torch.trainer import Trainer
    from tinyfaces_tpu_torch.utils.instruments import (card, check_transfer, device_name,
                                                       resolve_device)

    transfer = os.environ.get("BENCH_TRANSFER", "rgb")
    check_transfer(transfer, TRANSFERS)
    dev = resolve_device(args.device)
    bf16 = os.environ.get("BENCH_DTYPE") == "bf16"
    # fp32 means fp32: no TF32 in the convolutions or matmuls (main.run's rule)
    torch.backends.cuda.matmul.allow_tf32 = bf16
    torch.backends.cudnn.allow_tf32 = bf16
    name = card(dev)
    cfg = DetectorConfig()
    batch = int(os.environ.get("BENCH_BATCH", "12"))
    model = TinyFacesDetector(stage_sizes=stage_sizes, dtype=torch.bfloat16 if bf16 else None)
    init_model(model, torch.Generator().manual_seed(0))
    trainer = Trainer(model=model, cfg=cfg, tc=TrainConfig(batch_size=batch),
                      templates=load_templates(), device=dev)
    trainer.setup(steps_per_epoch=1000)

    rng = np.random.default_rng(0)
    if transfer == "jpegdct":
        pack = jpegdct_packer(rng, batch, cfg)
    else:
        pack = yuv420_pack if transfer == "yuv420" else (lambda b: b)
    host_batches = [pinned(pack(make_synthetic_train_batch(rng, batch, cfg)), dev)
                    for _ in range(1 + WINDOWS * STEPS_PER_WINDOW)]
    out = run(trainer, host_batches, windows=WINDOWS, steps_per_window=STEPS_PER_WINDOW)
    flops = train_step_flops(batch, cfg.input_size, stage_sizes) / batch
    kind = "bf16" if bf16 else "fp32"
    out.update(transfer=transfer, dtype=kind, batch=batch, card=name, flops_per_image=flops,
               **achieved(flops, out["value"], device_name(dev), kind))
    share = f", {100 * out['share_of_peak']:.1f}% of the {kind} peak" if out["share_of_peak"] else ""
    print(f"# {name}; transfer={transfer} {kind}, batch {batch}; warm-up {out['warmup_s']:.1f} s; "
          f"window rates {[round(r, 2) for r in out['window_rates']]} img/s (median of {WINDOWS} "
          f"windows of {STEPS_PER_WINDOW} steps); loss {out['first_loss']:.1f} -> "
          f"{out['last_loss']:.1f}; kernel launches: dense_assignment_reductions "
          f"{out['k1_launches']} in {out['steps']} timed steps and the warm-up; peak memory "
          + (f"{out['peak_gib']:.2f} GiB" if out["peak_gib"] is not None else "not measured (cpu)")
          + f"; {flops / 1e12:.4f} TFLOP/image fwd+bwd -> {out['tflops']:.2f} TFLOP/s{share}",
          file=sys.stderr, flush=True)
    print(json.dumps(out), file=sys.stderr, flush=True)  # the same, for scripts
    print(json.dumps(result_line(out["value"])), flush=True)
    return out


if __name__ == "__main__":
    main()

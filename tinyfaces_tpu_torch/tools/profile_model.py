"""FLOP count of the detector: each pyramid level's forward and the train
step's forward and backward, and their share of the card's peak.

    python -m tinyfaces_tpu_torch.tools.profile_model [--batch 16] [--device cuda]

Port of tools/profile_model.py. XLA's cost model has no counterpart, so
the count comes from `torch.utils.flop_counter.FlopCounterMode` over the
model built on the `meta` device: shapes only, no card and no memory
needed. It counts the convolutions (and any matmul) at 2 FLOPs a
multiply-add, forward and backward; batch norm, ReLU and the adds are
elementwise and not counted. `pyramid_flops` and `train_step_flops` are
what `bench`, `bench_train` and `tools.train_bench` divide by their times.

`peak_tflops` holds the published dense peaks of the cards it knows
(H100 SXM: 989 TFLOP/s bf16, 495 TF32, 67 fp32, NVIDIA's data sheet at
700 W); for any other card it gives None and no share is printed.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES

PYRAMID_LEVELS = ((192, 256), (384, 512), (768, 1024), (1536, 2048))  # the 768x1024 bucket's
# Published dense peaks (TFLOP/s) by `torch.cuda.get_device_name()`.
PEAK_TFLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989.0, "tf32": 495.0, "fp32": 67.0},
}


def peak_tflops(device_name: str, kind: str) -> Optional[float]:
    """Published dense peak of `device_name` for `kind` (bf16, tf32 or
    fp32), None for a card the table lacks."""
    return PEAK_TFLOPS.get(device_name, {}).get(kind)


def _meta_model(stage_sizes: Sequence[int], train: bool) -> TinyFacesDetector:
    with torch.device("meta"):
        model = TinyFacesDetector(stage_sizes=stage_sizes)
    return model.train(train)


def forward_flops(hw: tuple, batch: int = 1, stage_sizes: Sequence[int] = RESNET101_STAGES) -> float:
    """FLOPs of one eval-mode forward of `batch` (H, W) images."""
    model = _meta_model(stage_sizes, train=False)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.empty(batch, *hw, 3, device="meta"))
    return float(counter.get_total_flops())


def train_step_flops(batch: int = 12, hw: tuple = (500, 500),
                     stage_sizes: Sequence[int] = RESNET101_STAGES) -> float:
    """FLOPs of one train step's forward and backward (the gradients of
    every parameter; the input needs none)."""
    model = _meta_model(stage_sizes, train=True)
    with FlopCounterMode(display=False) as counter:
        model(torch.empty(batch, *hw, 3, device="meta")).sum().backward()
    return float(counter.get_total_flops())


def pyramid_flops(levels: Sequence[tuple] = PYRAMID_LEVELS,
                  stage_sizes: Sequence[int] = RESNET101_STAGES) -> float:
    """FLOPs of one image's pyramid: a forward at every level canvas."""
    return sum(forward_flops(hw, 1, stage_sizes) for hw in levels)


def achieved(flops_per_item: float, items_per_s: float, device_name: str, kind: str) -> dict:
    """TFLOP/s at `items_per_s` and its share of the card's peak (None for
    a card the table lacks)."""
    tflops = flops_per_item * items_per_s / 1e12
    peak = peak_tflops(device_name, kind)
    return {"tflops": tflops, "peak_tflops": peak, "share_of_peak": tflops / peak if peak else None}


def profile(batch: int = 16, stage_sizes: Sequence[int] = RESNET101_STAGES,
            levels: Sequence[tuple] = PYRAMID_LEVELS, train_batch: int = 12,
            train_hw: tuple = (500, 500)) -> dict:
    """Counts per level at `batch`, the pyramid per image, the train step."""
    per_level = {f"{h}x{w}": forward_flops((h, w), batch, stage_sizes) for h, w in levels}
    return {"batch": batch, "forward_flops": per_level,
            "pyramid_flops_per_image": sum(per_level.values()) / batch,
            "train_batch": train_batch, "train_hw": list(train_hw),
            "train_step_flops": train_step_flops(train_batch, train_hw, stage_sizes)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="the card whose peak the shares are taken of (the count needs none)")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.utils.instruments import card, device_name, resolve_device

    dev = resolve_device(args.device)
    name = device_name(dev)
    out = profile(args.batch)
    for level, flops in out["forward_flops"].items():
        print(f"fwd {level} batch={args.batch}: {flops / 1e12:.4f} TFLOP")
    per_image = out["pyramid_flops_per_image"]
    print(f"pyramid total: {per_image / 1e12:.4f} TFLOP/image")
    print(f"train step (fwd+bwd) batch={out['train_batch']} {out['train_hw'][0]}x"
          f"{out['train_hw'][1]}: {out['train_step_flops'] / 1e12:.4f} TFLOP")
    out["card"] = card(dev)
    out["peaks_tflops"] = {k: peak_tflops(name, k) for k in ("bf16", "tf32", "fp32")}
    for kind, peak in out["peaks_tflops"].items():
        if peak:
            # the least time the card could take at its published peak
            print(f"  at the {kind} peak ({peak:.0f} TFLOP/s, {out['card']}): pyramid "
                  f"{1e3 * per_image / (peak * 1e12):.3f} ms/image, train step "
                  f"{1e3 * out['train_step_flops'] / (peak * 1e12):.3f} ms")
    if not any(out["peaks_tflops"].values()):
        print(f"  no published peak for {name!r}: no share printed")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

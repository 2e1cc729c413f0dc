"""Smoke run of the PyTorch/CUDA port (tinyfaces_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its findings; any failure raises and exits non-zero:

  0. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off, so float32 means float32;
  1. build: compiles the dense-assignment CUDA kernel from csrc/;
  2. kernel vs its plain PyTorch twin on the card, B=12 over the 63x63x25
     anchor grid with G in {8, 192, 512} and a ragged 61x63 grid, image 0
     of each batch without valid GT: with noise off the values agree within
     1e-6 and the indices wherever the top-2 gap exceeds 3e-6; with noise
     on, the label maps of assign_targets_fused disagree on < 0.2% of
     anchors; both are timed with CUDA events (median of 20);
  3. train: Trainer.train_epoch on full ResNet-101 at batch 12, 500x500,
     fp32, default DetectorConfig, the real templates, over a seeded
     in-memory dataset; losses finite, parameters moved, the upsample
     frozen, and the kernel launched on every step;
  4. checkpoint: save, load into a fresh Trainer, one more step from each
     gives identical losses.

The second-to-last line of output is the card's `nvidia-smi` name and power
limit; before it, one JSON line describes each kernel; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from tinyfaces_tpu.config import DetectorConfig, TrainConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.data.loader import PrefetchLoader
from tinyfaces_tpu_torch.data.targets import normalize_images
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.ops import assignment_kernel
from tinyfaces_tpu_torch.ops.assignment import compose_targets, compute_pad_mask
from tinyfaces_tpu_torch.ops.dense_overlap import compute_dense_overlap
from tinyfaces_tpu_torch.trainer import Trainer, load_checkpoint, save_checkpoint

ROOT = Path(__file__).resolve().parent
RF = dict(ofx=-1.0, ofy=-1.0, stx=8.0, sty=8.0)
MEAN_PIXEL = (123, 116, 103)  # uint8 ImageNet mean, the reference canvas fill
N_SAMPLES = 96  # 8 steps of batch 12


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> float:
    """Median of `runs` CUDA-event timings of fn()."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def scene(rng, b, g, input_hw=(500, 500)):
    """GT boxes of 8-300 px inside the image; image 0 has no valid GT."""
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(1, b):
        n = int(rng.integers(1, g + 1))
        w, h = rng.uniform(8, 300, n), rng.uniform(8, 300, n)
        x1, y1 = rng.uniform(0, input_hw[1] - w), rng.uniform(0, input_hw[0] - h)
        boxes[i, :n] = np.stack([x1, y1, x1 + w, y1 + h], 1)
        valid[i, :n] = True
    return boxes, valid


def phase_kernel(templates: torch.Tensor, dev: torch.device, name: str) -> dict:
    rng = np.random.default_rng(0)
    b = 12
    max_err = 0.0
    result = {}
    for label, vsy, vsx, g in (("G8", 63, 63, 8), ("G192", 63, 63, 192),
                               ("G512", 63, 63, 512), ("ragged61x63", 61, 63, 192)):
        boxes_np, valid_np = scene(rng, b, g)
        boxes = torch.from_numpy(boxes_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        seed = torch.arange(b, dtype=torch.int32, device=dev)
        kw = dict(vsx=vsx, vsy=vsy, **RF)

        # Noise off: values within 1e-6, indices equal where decisive.
        got = assignment_kernel.dense_assignment_reductions(boxes, valid, templates, seed,
                                                            noise=False, **kw)
        torch.cuda.synchronize()
        want = assignment_kernel.dense_assignment_reductions_reference(boxes, valid, templates,
                                                                       seed, noise=False, **kw)
        err = max((got[0] - want[0]).abs().max().item(), (got[2] - want[2]).abs().max().item())
        pert = torch.where(valid[:, None, None, None, :],
                           compute_dense_overlap(RF["ofx"], RF["ofy"], RF["stx"], RF["sty"],
                                                 vsx, vsy, templates, boxes, valid), -1.0)
        top2 = pert.topk(2, dim=4).values
        decisive = top2[..., 0] - top2[..., 1] > 3e-6
        flat_top2 = pert.reshape(b, -1, g).topk(2, dim=1).values
        fdecisive = flat_top2[:, 0] - flat_top2[:, 1] > 3e-6
        del pert
        gt_bad = (got[1] != want[1])[decisive].sum().item()
        idx_bad = (got[3] != want[3])[fdecisive].sum().item()
        check(err <= 1e-6, f"{label}: value error {err} > 1e-6")
        check(gt_bad == 0 and idx_bad == 0, f"{label}: {gt_bad} best_gt / {idx_bad} pgt_idx mismatches")
        max_err = max(max_err, err)

        # Noise on: labels through assign_targets_fused vs the twin's composition.
        paste = torch.tensor([[0.0, 0.0, 500.0, 500.0]], device=dev).expand(b, 4)
        flip = torch.arange(b, device=dev) % 2 == 1
        pad = compute_pad_mask(paste, templates, vsx=vsx, vsy=vsy, flip=flip, **RF)
        thr = dict(pos_thresh=0.7, neg_thresh=0.3)
        cls_k, reg_k = assignment_kernel.assign_targets_fused(
            boxes, valid, pad, templates, torch.Generator(device=dev).manual_seed(1), **thr, **RF)
        vd = assignment_kernel.drop_degenerate(boxes, valid)
        red = assignment_kernel.dense_assignment_reductions_reference(
            boxes, vd, templates, seed + 100, noise=True, **kw)
        cls_t, _ = compose_targets(*red, boxes, vd, pad, templates, **thr, **RF)
        mismatch = (cls_k != cls_t).float().mean().item()
        check(mismatch < 0.002, f"{label}: noisy label mismatch {mismatch}")
        check(bool((cls_k[0] == -1).all()) and bool((reg_k[0] == 0).all()), f"{label}: no-GT image")
        check(bool(torch.isfinite(reg_k).all()), f"{label}: non-finite regression")
        print(f"kernel {label}: B={b} {vsy}x{vsx}x{templates.shape[0]} G={g}: max value err {err:.3g}, "
              f"decisive anchors {decisive.float().mean().item():.4f}, "
              f"noisy label mismatch {mismatch:.2e}", flush=True)

        if label == "G192":  # the main path's shape
            args = (boxes, valid, templates, seed)
            result["ms"] = cuda_ms(lambda: assignment_kernel.dense_assignment_reductions(*args, **kw))
            result["plain_ms"] = cuda_ms(
                lambda: assignment_kernel.dense_assignment_reductions_reference(*args, **kw))
            print(f"kernel time B=12 63x63x25 G=192 noise on: kernel {result['ms']:.4f} ms, "
                  f"plain twin {result['plain_ms']:.4f} ms (CUDA events, median of 20; {name})",
                  flush=True)
    result["max_abs_err"] = max_err
    return result


def make_dataset(cfg: DetectorConfig, n: int, seed: int = 0) -> list[dict]:
    """Train-sample dicts as WIDERFace.__getitem__ returns them: a uint8
    canvas with a pasted crop, 0-40 GT boxes of 8-300 px inside it padded to
    max_gt, and a random flip."""
    rng = np.random.default_rng(seed)
    ih, iw = cfg.input_size
    items = []
    for _ in range(n):
        px1, py1 = (rng.uniform(0, 0.3, 2) * (iw, ih)).round()
        px2, py2 = np.round(rng.uniform((px1 + 0.4 * iw, py1 + 0.4 * ih), (iw, ih)))
        canvas = np.empty((ih, iw, 3), np.uint8)
        canvas[:] = MEAN_PIXEL
        canvas[int(py1):int(py2), int(px1):int(px2)] = rng.integers(
            0, 256, (int(py2 - py1), int(px2 - px1), 3), dtype=np.uint8)
        k = int(rng.integers(0, min(40, cfg.max_gt) + 1))
        w = rng.uniform(8, np.minimum(300, px2 - px1), k)
        h = rng.uniform(8, np.minimum(300, py2 - py1), k)
        x1, y1 = rng.uniform(px1, px2 - w), rng.uniform(py1, py2 - h)
        gt = np.zeros((cfg.max_gt, 4), np.float32)
        gt[:k] = np.stack([x1, y1, x1 + w, y1 + h], 1)
        items.append({"image": canvas, "gt_boxes": gt, "gt_valid": np.arange(cfg.max_gt) < k,
                      "paste_box": np.array([px1, py1, px2, py2], np.float32),
                      "flip": bool(rng.integers(0, 2))})
    return items


def forward_vs_cpu(model: TinyFacesDetector, dev: torch.device) -> None:
    """Eval-mode forward on the card against the same weights on the CPU at
    a small input; both fp32 (TF32 off), summed in another order."""
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 128, 128, 3)).astype(np.float32))
    cpu_model = TinyFacesDetector()
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    model.eval()
    with torch.no_grad():
        got = model(x.to(dev)).cpu()
        want = cpu_model.eval()(x)
    model.train()
    diff = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(diff <= 1e-4 * max(scale, 1.0), f"GPU vs CPU forward differ by {diff} (scale {scale})")
    print(f"forward GPU vs CPU, eval, 2x128x128: max |diff| {diff:.3g} of scale {scale:.3g}",
          flush=True)


def phase_train(templates_np, dev: torch.device, name: str):
    cfg, tc = DetectorConfig(), TrainConfig()
    dataset = make_dataset(cfg, N_SAMPLES)
    model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, tc, templates_np, device=dev, seed=0)
    trainer.setup(steps_per_epoch=len(dataset) // tc.batch_size)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    forward_vs_cpu(model, dev)

    assignment_kernel.launch_count = 0
    torch.cuda.reset_peak_memory_stats(dev)
    timer = trainer.train_epoch(dataset, epoch=0)
    torch.cuda.synchronize(dev)
    launches = assignment_kernel.launch_count
    peak = torch.cuda.max_memory_allocated(dev)

    steps = len(dataset) // tc.batch_size
    check(trainer.step == steps and launches == steps, f"{launches} kernel launches in {trainer.step} steps")
    check(trainer.skipped_steps == 0, f"{trainer.skipped_steps} non-finite steps")
    check(math.isfinite(trainer.class_average.average) and math.isfinite(trainer.reg_average.average),
          "non-finite average loss")
    after = model.state_dict()
    check(torch.equal(after["score4_upsample.weight"], before["score4_upsample.weight"]),
          "upsample kernel changed")
    for prefix in ("model.", "score_res3.", "score_res4."):
        check(any(not torch.equal(after[k], before[k]) for k in after if k.startswith(prefix)),
              f"{prefix} parameters did not move")
    ms = 1000.0 * timer.elapsed / timer.measured_steps
    print(f"train ResNet-101 B={tc.batch_size} {cfg.input_size[0]}x{cfg.input_size[1]} fp32: "
          f"{timer.measured_steps} steady steps "
          f"(step 0 excluded), {ms:.2f} ms/step, {timer.items_per_sec:.2f} img/s, "
          f"peak memory {peak / 2**30:.2f} GiB, kernel launches {launches} ({name})", flush=True)

    # The trained detector's output at the full input: shape and finite.
    model.eval()
    with torch.no_grad():
        full = model(normalize_images(torch.from_numpy(dataset[0]["image"][None]).to(dev)))
    check(tuple(full.shape) == (1, *cfg.heatmap_size, cfg.out_channels)
          and bool(torch.isfinite(full).all()), f"forward output {tuple(full.shape)}")
    print(f"forward {tuple(dataset[0]['image'][None].shape)} -> {tuple(full.shape)} finite",
          flush=True)
    model.train()
    return trainer, dataset, launches


def phase_checkpoint(trainer: Trainer, dataset: list, templates_np, dev: torch.device):
    out_dir = ROOT / "build" / "chip_smoke"
    path = save_checkpoint(trainer.model, trainer.opt, trainer.step, epoch=0,
                           batch_size=trainer.tc.batch_size, save_path=out_dir)
    fresh = Trainer(init_model(TinyFacesDetector(), torch.Generator().manual_seed(1)),
                    trainer.cfg, trainer.tc, templates_np, device=dev, seed=trainer.seed)
    fresh.setup(steps_per_epoch=len(dataset) // trainer.tc.batch_size)
    fresh.restore(load_checkpoint(path, map_location=dev))
    batch = next(iter(PrefetchLoader(dataset, trainer.tc.batch_size, device=dev, seed=5)))
    la, lb = trainer.train_step(batch), fresh.train_step(batch)
    la, lb = [x.item() for x in la], [x.item() for x in lb]
    check(la == lb, f"losses after restore differ: {la} vs {lb}")
    print(f"checkpoint round trip: one more step from each gives loss {la[0]:.6f} == {lb[0]:.6f}",
          flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    assignment_kernel._kernel()
    print(f"build: dense_assignment.cu compiled and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)

    templates_np = load_templates()
    templates = torch.tensor(templates_np, dtype=torch.float32, device=dev)
    kres = phase_kernel(templates, dev, name)
    trainer, dataset, launches = phase_train(templates_np, dev, name)
    phase_checkpoint(trainer, dataset, templates_np, dev)

    print(json.dumps({"kernels": [{
        "name": "dense_assignment_reductions",
        "route": "cuda",
        "source": "tinyfaces_tpu_torch/csrc/dense_assignment.cu",
        "replaces": "tinyfaces_tpu/ops/pallas_assignment.py:209",
        "launches": launches,
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"],
        "plain_ms": kres["plain_ms"],
    }]}))
    print(name)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

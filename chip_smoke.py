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
     anchors; both are timed with CUDA events (median of 20) at the train
     step's shapes, whose bound is reckoned from the timed inputs;
  3. train: Trainer.train_epoch on full ResNet-101 at batch 12, 500x500,
     fp32, default DetectorConfig, the real templates, over a seeded
     in-memory dataset; losses finite, parameters moved, the upsample
     frozen, and the kernel launched on every step;
  4. checkpoint: save, load into a fresh Trainer, one more step from each
     gives identical losses;
  5. inference against the CPU: full-depth ResNet-101 with seeded weights,
     BN running statistics recalibrated on the smoke's images, regression
     weights scaled to 1%, class weights scaled to a largest logit of 10 and
     the class biases shifted so 3% of the cells that may fire clear
     prob_thresh (set-up only: random weights give
     eval outputs far from a trained model's); the fused pyramid for 2
     images of ~192x256 at scales (-1, 0, 1), fp32 with TF32 off, on the
     card and on the CPU: the same survivors wherever neighbouring
     candidates' scores are more than 1e-4 apart, boxes within 1e-2 px,
     scores within 1e-3;
  6. full-width pyramid on the card: EvalConfig() defaults (scales -2..1,
     K 1000, 750 out), the 768x1024 bucket at batch 32, bf16 and fp32:
     img/s over timed batches after warm-up, batch-1 latency, peak memory
     and a CUDA-event split (upload, resize, forward per level, decode,
     NMS, copy back);
  7. sweep and service: evaluate_model.run over 64 in-memory images of
     mixed sizes (3 buckets) writes the result tree under
     build/chip_smoke/, checked for count and format; DetectionService
     answers 16 requests from 4 threads with detect_batch's results;
  8. training through the CLI: a synthetic WIDER train tree of 48 images at
     WIDER sizes (long side 1024) with 1/f-spectrum pixels, 1-40 faces of
     10-300 px each and two crowd images of ~1000 faces of 10-20 px (so
     crops exceed max_gt 192), its annotation file written under
     build/chip_smoke/; decode hands in the in-memory arrays, everything
     after it is the port's own code. `main.run` with the CLI defaults
     (ResNet-101, batch 12, 500x500, fp32, the C++ engine) for `--epochs 2
     --save-every 1 --metrics-log ...`, then `--resume checkpoint_1
     --epochs 2` from a fresh model, each call entered with TF32 on: the
     CLI turned TF32 off for matmuls and convolutions, every sample came from
     the C++ engine, K1 launched once per step, losses finite, both
     checkpoints written, the JSONL holds the per-step records and an
     epoch_end record whose gt_dropped_boxes is > 0 and equals the overflow
     counters, and the resumed epoch gives the uninterrupted run's per-step
     losses within rtol 1e-5 (cuDNN's algorithm choice moves the 7th digit).

The kernel build and the C++ engine build run side by side in phase 1.
The second-to-last line of output is the card's `nvidia-smi` name and power
limit; before it, one JSON line describes each kernel (its launches on each
path, error, times, bound), before that one JSON line holds phase 8's
training numbers and before that one the inference numbers; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from tinyfaces_tpu_torch import evaluate_model
from tinyfaces_tpu_torch import main as train_cli
from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig, TrainConfig
from tinyfaces_tpu_torch.data import WIDERFace, load_templates, native, overflow
from tinyfaces_tpu_torch.data.loader import PrefetchLoader
from tinyfaces_tpu_torch.data.targets import normalize_images
from tinyfaces_tpu_torch.evaluation import PyramidDetector
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.ops import assignment_kernel
from tinyfaces_tpu_torch.ops.assignment import compose_targets, compute_pad_mask
from tinyfaces_tpu_torch.ops.dense_overlap import compute_dense_overlap
from tinyfaces_tpu_torch.serving import DetectionService
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
    cfg = DetectorConfig()
    b = TrainConfig().batch_size
    hy, hx = cfg.heatmap_size
    main_shape = (hy, hx, cfg.max_gt)  # the train step's: timed, and its bound reckoned
    max_err = 0.0
    result = {}
    for label, vsy, vsx, g in (("G8", hy, hx, 8), (f"G{cfg.max_gt}", hy, hx, cfg.max_gt),
                               ("G512", hy, hx, 512), (f"ragged{hy - 2}x{hx}", hy - 2, hx, cfg.max_gt)):
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

        if (vsy, vsx, g) == main_shape:
            args = (boxes, valid, templates, seed)
            result["ms"] = cuda_ms(lambda: assignment_kernel.dense_assignment_reductions(*args, **kw))
            result["plain_ms"] = cuda_ms(
                lambda: assignment_kernel.dense_assignment_reductions_reference(*args, **kw))
            nb, ng = boxes.shape[:2]  # the timed inputs' shapes
            result["bound_ms"], result["bound_by"] = k1_bound(nb, vsy, vsx, templates.shape[0], ng)
            print(f"kernel time B={b} {vsy}x{vsx}x{templates.shape[0]} G={g} noise on: "
                  f"kernel {result['ms']:.4f} ms, "
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
    trainer = Trainer(model, cfg, tc, templates_np, device=dev, seed=0, augment="python")
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
                    trainer.cfg, trainer.tc, templates_np, device=dev, seed=trainer.seed,
                    augment="python")
    fresh.setup(steps_per_epoch=len(dataset) // trainer.tc.batch_size)
    fresh.restore(load_checkpoint(path, map_location=dev))
    batch = next(iter(PrefetchLoader(dataset, trainer.tc.batch_size, device=dev, seed=5)))
    la, lb = trainer.train_step(batch), fresh.train_step(batch)
    la, lb = [x.item() for x in la], [x.item() for x in lb]
    check(la == lb, f"losses after restore differ: {la} vs {lb}")
    print(f"checkpoint round trip: one more step from each gives loss {la[0]:.6f} == {lb[0]:.6f}",
          flush=True)


PROB_LOGIT = math.log(EvalConfig().prob_thresh / (1 - EvalConfig().prob_thresh))


def pink_images(rng, sizes) -> list:
    """uint8 images with a 1/f amplitude spectrum: the scale-free statistics
    of natural images, so every pyramid level looks alike to the network
    (white noise would not: downscaling averages it away)."""
    out = []
    for h, w in sizes:
        fy, fx = np.fft.fftfreq(h)[:, None], np.fft.rfftfreq(w)[None, :]
        amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))
        spec = amp[..., None] * (rng.normal(size=(h, fx.shape[1], 3))
                                 + 1j * rng.normal(size=(h, fx.shape[1], 3)))
        img = np.fft.irfft2(spec, s=(h, w), axes=(0, 1))
        img = (img - img.mean()) / img.std() * 60.0 + 120.0
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def calibrate(model: TinyFacesDetector, images: list, dev: torch.device, fraction: float = 0.03):
    """Smoke set-up for seeded weights: BN running statistics become the
    mean of the batch statistics over the images at levels 0.5, 1 and 2;
    the regression weights shrink to 1% (so exp(tw) stays near 1); the
    class weights scale so the largest logit is 10, a trained detector's
    range (seeded heads reach ~50, where float32 differences between two
    devices exceed the 1e-3 score tolerance); the class biases shift so
    `fraction` of the cells that may fire clear prob_thresh. Returns the
    per-level counts of such cells per image."""
    h, w = min(im.shape[0] for im in images), min(im.shape[1] for im in images)
    x = normalize_images(torch.from_numpy(np.stack([im[:h, :w] for im in images])).to(dev))
    x = x.permute(0, 3, 1, 2)
    levels = [F.interpolate(x, scale_factor=2.0**s, mode="bilinear", antialias=s < 0)
              for s in (-1, 0, 1)]
    bns = [m for m in model.modules() if m.__class__.__name__ == "BatchNorm2d"]
    t = model.num_templates
    heads = (model.score_res3, model.score_res4)
    with torch.no_grad():
        model.train()
        for i, xl in enumerate(levels):
            for bn in bns:
                bn.momentum = 1.0 / (i + 1)  # running mean over the forwards
            model(xl.permute(0, 2, 3, 1))
        for bn in bns:
            bn.momentum = 0.1
        model.eval()
        for head in heads:
            head.weight[t:] *= 0.01
        # the ids that may fire; the class biases are still 0, so the
        # logits scale with the class weights
        logits = [model(xl.permute(0, 2, 3, 1))[..., 4:12] for xl in levels]
        gain = 10.0 / max(float(g.abs().max()) for g in logits)
        for head in heads:
            head.weight[:t] *= gain
        logits = [g * gain for g in logits]
        shift = PROB_LOGIT - torch.quantile(torch.cat([g.flatten() for g in logits]), 1 - fraction)
        model.score_res3.bias[:t] += shift
        return [int(((g + shift) > PROB_LOGIT).sum()) // len(images) for g in logits]


def iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, M) continuous-coordinate IoU (the NMS convention)."""
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = lambda z: (z[:, 2] - z[:, 0]) * (z[:, 3] - z[:, 1])  # noqa: E731
    union = area(a)[:, None] + area(b)[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)


def match_detections(got: np.ndarray, want: np.ndarray, nms_thresh: float = 0.3,
                     box_tol=1e-2, score_tol=1e-3, near=1e-4):
    """Pairs the (N, 5) rows of got and want within box_tol px and
    score_tol. A row left unpaired must come from a tie the two runs may
    break apart: its score within `near` of another candidate's (an NMS or
    top-K order), of the prob_thresh logit or of the lowest kept score; or
    its IoU with a higher-scoring survivor within 1e-3 of nms_thresh; or it
    overlaps (IoU > nms_thresh - 1e-3) another unpaired row so explained,
    whose flip decided its fate. Returns (pairs, unpaired, max box error,
    max score error)."""
    used = np.zeros(len(got), bool)
    box_err = score_err = 0.0
    paired = np.zeros(len(want), bool)
    for j, w in enumerate(want):
        ok = ~used & (np.abs(got[:, :4] - w[:4]).max(1) <= box_tol) & (np.abs(got[:, 4] - w[4]) <= score_tol)
        if ok.any():
            i = int(np.argmax(ok))
            used[i] = paired[j] = True
            box_err = max(box_err, float(np.abs(got[i, :4] - w[:4]).max()))
            score_err = max(score_err, float(abs(got[i, 4] - w[4])))
    both = np.concatenate([got, want])
    lone = both[np.concatenate([~used, ~paired])]
    if len(lone):
        scores = both[:, 4]
        iou = iou_np(lone[:, :4], both[:, :4])
        above = scores[None, :] > lone[:, 4:5]
        explained = ((np.abs(scores[None, :] - lone[:, 4:5]) <= near).sum(1) >= 2) \
            | (np.abs(lone[:, 4] - PROB_LOGIT) <= near) | (np.abs(lone[:, 4] - scores.min()) <= near) \
            | (above & (np.abs(iou - nms_thresh) <= 1e-3)).any(1)
        links = iou_np(lone[:, :4], lone[:, :4]) > nms_thresh - 1e-3
        for _ in range(len(lone)):
            explained = explained | (links & explained[None, :]).any(1)
        for row in lone[~explained]:
            print(f"unpaired detection {row.tolist()}: best IoU with a higher-scoring row "
                  f"{(iou_np(row[None, :4], both[:, :4]) * (scores > row[4])).max():.6f}", flush=True)
        check(bool(explained.all()), f"{int((~explained).sum())} unpaired detections are no near-ties")
    return int(paired.sum()), len(lone), box_err, score_err


def phase_inference_vs_cpu(templates_np, dev: torch.device):
    rng = np.random.default_rng(5)
    images = pink_images(rng, [(192, 256), (176, 248)])
    model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0)).to(dev)
    counts = calibrate(model, images, dev)
    print(f"calibration: cells above prob_thresh per image at levels 0.5/1/2: {counts}", flush=True)
    check(min(counts) > 0, "a pyramid level has no candidates")
    ec = EvalConfig(scales=(-1, 0, 1))
    gpu = PyramidDetector(model, templates_np, DetectorConfig(), ec, device=dev)
    cpu = PyramidDetector(copy.deepcopy(model).cpu(), templates_np, DetectorConfig(), ec, device="cpu")
    got, want = gpu.detect_batch(images), cpu.detect_batch(images)
    out = {"pairs": 0, "unpaired": 0, "max_box_err_px": 0.0, "max_score_err": 0.0}
    for g, w in zip(got, want):
        check(g.shape[1] == 5 and np.isfinite(g).all() and len(w) > 20, f"card output {g.shape}, CPU {w.shape}")
        p, u, be, se = match_detections(g, w)
        check(p >= 0.98 * max(len(g), len(w)), f"only {p} of {len(g)}/{len(w)} detections paired")
        out["pairs"] += p
        out["unpaired"] += u
        out["max_box_err_px"] = max(out["max_box_err_px"], be)
        out["max_score_err"] = max(out["max_score_err"], se)
    print(f"pyramid card vs CPU, ResNet-101 fp32, 2 images ~192x256, scales (-1, 0, 1): "
          f"{out['pairs']} detections paired, {out['unpaired']} unpaired near-ties, max box error "
          f"{out['max_box_err_px']:.3g} px, max score error {out['max_score_err']:.3g}", flush=True)
    return model, out


def conv_flops(model: TinyFacesDetector, hw: tuple, dev: torch.device) -> float:
    """Convolution FLOPs (2 x MACs) of one forward at input size hw."""
    total = [0.0]

    def hook(m, inp, out):
        total[0] += 2.0 * out.numel() * m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        model(torch.zeros(1, *hw, 3, device=dev))
    for h in handles:
        h.remove()
    return total[0]


def split_ms(trace: list) -> dict:
    """Elapsed ms per phase from consecutive (phase, event) marks; levels'
    resize and decode summed, forwards kept per level."""
    out: dict = {}
    for (_, a), (phase, b) in zip(trace, trace[1:]):
        key = phase if phase.startswith("forward") else phase.split()[0]
        out[key] = out.get(key, 0.0) + a.elapsed_time(b)
    return out


def phase_full_width(calibrated: TinyFacesDetector, templates_np, dev: torch.device, name: str):
    rng = np.random.default_rng(6)
    b = 32
    images = pink_images(rng, [(768, 1024)] * b)
    levels = [(192, 256), (384, 512), (768, 1024), (1536, 2048)]
    tflop = sum(conv_flops(calibrated, hw, dev) for hw in levels) / 1e12
    print(f"4-level pyramid of one 768x1024 image: {tflop:.3f} TFLOP of convolution", flush=True)
    results = {"conv_tflop_per_image": tflop}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        model = TinyFacesDetector(dtype=dtype).to(dev)
        model.load_state_dict(calibrated.state_dict())
        det = PyramidDetector(model, templates_np, DetectorConfig(), EvalConfig(), device=dev)
        t0 = time.perf_counter()
        packed = det.pack_inputs(images)
        pack_ms = 1000.0 * (time.perf_counter() - t0)
        for _ in range(2):  # warm-up: cuDNN's first calls
            det._fetch(det.detect_batch_async(packed))
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        n = 3
        t0 = time.perf_counter()
        for _ in range(n):
            outs = det._fetch(det.detect_batch_async(packed))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        for o in outs:
            check(o.ndim == 2 and o.shape[1] == 5 and np.isfinite(o).all(), f"{label}: output {o.shape}")
        start = torch.cuda.Event(enable_timing=True)
        det.trace = [("start", start)]
        start.record()
        det._fetch(det.detect_batch_async(packed))
        split = split_ms(det.trace)
        det.trace = None
        lat = []
        for i in range(7):
            t0 = time.perf_counter()
            det.detect_batch(images[i:i + 1])
            lat.append(1000.0 * (time.perf_counter() - t0))
        r = {"img_per_s": n * b / wall, "batch_ms": 1000.0 * wall / n, "pack_ms": pack_ms,
             "batch1_ms": float(np.median(lat[2:])), "peak_gib": peak,
             "split_ms": {k: round(v, 3) for k, v in split.items()},
             "dets_per_image": float(np.mean([len(o) for o in outs]))}
        results[label] = r
        print(f"pyramid {label} ResNet-101, 768x1024 bucket, batch {b}, EvalConfig() defaults: "
              f"{r['img_per_s']:.2f} img/s ({r['batch_ms']:.1f} ms/batch over {n} batches after 2 "
              f"warm-up; host pack {pack_ms:.1f} ms/batch not included), batch-1 latency "
              f"{r['batch1_ms']:.2f} ms (median of 5, pack included), peak memory {peak:.2f} GiB, "
              f"{r['dets_per_image']:.1f} detections/image ({name})", flush=True)
        print(f"  CUDA-event split of one batch (ms): {json.dumps(r['split_ms'])}", flush=True)
        del model, det
        torch.cuda.empty_cache()
    return results


class MemoryDataset:
    """(uint8 image, img_path) items, as WIDERFace(split="val") gives them."""

    def __init__(self, items: list):
        self.items = items

    def __len__(self) -> int:
        return len(self.items)

    def __getitem__(self, idx: int):
        return self.items[idx]


def phase_sweep_and_service(calibrated: TinyFacesDetector, templates_np, dev: torch.device):
    import shutil

    rng = np.random.default_rng(7)
    sizes = [(300, 400)] * 24 + [(480, 360)] * 24 + [(200, 300)] * 16  # 3 buckets
    items = [(im, f"{i % 4}--Event{i % 4}/smoke_{i}.jpg")
             for i, im in enumerate(pink_images(rng, sizes))]
    out_dir = ROOT / "build" / "chip_smoke" / "val_results"
    shutil.rmtree(out_dir, ignore_errors=True)
    bf16 = TinyFacesDetector(dtype=torch.bfloat16).to(dev)
    bf16.load_state_dict(calibrated.state_dict())
    det = PyramidDetector(bf16, templates_np, DetectorConfig(), EvalConfig(), device=dev)
    evaluate_model.run(det, MemoryDataset(items), 0.03, 0.3, "val", results_dir=out_dir,
                       eval_batch=32, workers=4)
    files = sorted(out_dir.glob("*/*.txt"))
    check(len(files) == len(items), f"{len(files)} result files for {len(items)} images")
    n_dets = 0
    for f in files:
        lines = f.read_text().splitlines()
        check(lines[0] == f.stem + ".jpg" and int(lines[1]) == len(lines) - 2, f"{f}: header")
        for row in lines[2:]:
            v = row.split()
            check(len(v) == 5 and all(x.lstrip("-").isdigit() for x in v[:4]), f"{f}: row {row!r}")
            float(v[4])
        n_dets += int(lines[1])
    ph = evaluate_model.run.last_phases
    print(f"sweep: {len(files)} result files, {n_dets} detections, {ph['images_per_sec']:.2f} img/s "
          f"over {ph['wall']:.2f} s (bf16, 3 buckets, eval batch 32, first batch included)", flush=True)

    # Service: fp32, so the batches it forms give detect_batch's results.
    fp32 = PyramidDetector(calibrated, templates_np, DetectorConfig(), EvalConfig(), device=dev)
    reqs = pink_images(rng, [(192, 256), (300, 400)] * 8)
    want = [fp32.detect_batch([im])[0] for im in reqs]
    svc = DetectionService(fp32, max_batch=8, max_delay_ms=20)
    futures = [None] * len(reqs)

    def client(t):
        for i in range(t, len(reqs), 4):
            futures[i] = svc.submit(reqs[i])

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            check(not th.is_alive(), "a client thread hung")
        got = [f.result(timeout=300) for f in futures]
    finally:
        svc.close()
    pairs = unpaired = 0
    for g, w in zip(got, want):
        p, u, _, _ = match_detections(g, w)
        check(len(w) > 0 and p >= 0.98 * max(len(g), len(w)), f"service {g.shape} vs detect_batch {w.shape}")
        pairs, unpaired = pairs + p, unpaired + u
    print(f"service: 16 requests from 4 threads, 2 buckets: {pairs} detections equal detect_batch's, "
          f"{unpaired} unpaired near-ties", flush=True)
    return {"sweep_img_per_s": ph["images_per_sec"], "sweep_files": len(files),
            "service_pairs": pairs, "service_unpaired": unpaired}


class MemoryTrainSet(WIDERFace):
    """The train WIDERFace of an annotation file whose pixels are handed in
    decoded: `_decode` returns the in-memory array, so the smoke needs no
    image decoder; augmentation and everything after it are the port's."""

    def __init__(self, ann: Path, images: list, templates_np, cfg: DetectorConfig):
        super().__init__(ann, templates_np, cfg=cfg, split="train")
        self.images = images

    def _decode(self, idx: int) -> np.ndarray:
        return self.images[idx]


TRAIN_TREE_SIZES = [(683, 1024), (1024, 683), (768, 1024)]  # WIDER's long side is 1024
CROWDS = (5, 30)  # images holding ~1000 faces of 10-20 px


def write_train_tree(out_dir: Path, rng, n: int = 48) -> tuple[Path, list]:
    """n 1/f-spectrum images at WIDER sizes and their WIDER-format
    annotation file: 1-40 faces of 10-300 px per image, ~1000 faces of
    10-20 px in the crowd images."""
    images = pink_images(rng, [TRAIN_TREE_SIZES[i % 3] for i in range(n)])
    lines = []
    for i, im in enumerate(images):
        h, w = im.shape[:2]
        if i in CROWDS:
            k = int(rng.integers(950, 1050))
            fw = rng.uniform(10, 20, k)
        else:
            k = int(rng.integers(1, 41))
            fw = rng.uniform(10, 300, k)
        fh = np.minimum(fw * rng.uniform(1.0, 1.3, k), h - 2)
        x1, y1 = rng.uniform(0, w - fw - 1), rng.uniform(0, h - fh - 1)
        lines += [f"{i % 4}--Event{i % 4}/train_{i}.jpg", str(k)]
        lines += [f"{int(a)} {int(b)} {max(1, int(c))} {max(1, int(d))} 0 0 0 0 0 0"
                  for a, b, c, d in zip(x1, y1, fw, fh)]
    ann = out_dir / "wider_face_train_bbx_gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    return ann, images


def step_records(path: Path) -> tuple[list, list]:
    records = [json.loads(line) for line in path.read_text().splitlines()]
    return ([r for r in records if "event" not in r],
            [r for r in records if r.get("event") == "epoch_end"])


def phase_train_cli(templates_np, dev: torch.device, name: str) -> tuple[dict, int]:
    out = ROOT / "build" / "chip_smoke" / "train_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.perf_counter()
    ann, images = write_train_tree(out, np.random.default_rng(8))
    cfg, tc = DetectorConfig(), TrainConfig()
    dataset = MemoryTrainSet(ann, images, templates_np, cfg)
    n_faces = sum(len(s.bboxes) for s in dataset.samples)
    print(f"train tree: {len(images)} images, {n_faces} faces, written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # The C++ engine alone on one batch of the tree's images (8 threads).
    batch_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        native.native_augment_batch(images[:tc.batch_size],
                                    [s.bboxes for s in dataset.samples[:tc.batch_size]],
                                    cfg.input_size, cfg.neg_thresh, cfg.max_gt, seed=1, n_threads=8)
        batch_ms.append(1000.0 * (time.perf_counter() - t0))

    def cli(run_dir: Path, *extra: str):
        run_dir.mkdir()
        args = train_cli.arguments([str(ann), str(ann), "--device", str(dev), *extra])
        # TF32 on, as cuDNN has it in a fresh process: the fp32 CLI must turn it off.
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with contextlib.chdir(run_dir):  # weights/ goes under the run's directory
            trainer = train_cli.run(args, dataset)
        check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
              "the fp32 CLI left TF32 on")
        return trainer

    overflow.reset()
    native.counters.update(samples=0, seconds=0.0)
    assignment_kernel.launch_count = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    full = cli(out / "full", "--epochs", "2", "--save-every", "1",
               "--metrics-log", str(out / "full.jsonl"))
    full_wall = time.perf_counter() - t0
    dropped = overflow.snapshot()["dropped_boxes"]
    wait_ms = full.loader_wait_ms[1:]
    resumed = cli(out / "resumed", "--resume", str(out / "full" / "weights" / "checkpoint_1"),
                  "--epochs", "2", "--metrics-log", str(out / "resumed.jsonl"))
    torch.cuda.synchronize(dev)
    launches = assignment_kernel.launch_count
    samples, native_s = native.counters["samples"], native.counters["seconds"]
    peak = torch.cuda.max_memory_allocated(dev)

    per_epoch = len(dataset) // tc.batch_size
    steps = full.step + resumed.step - per_epoch
    check(full.step == 2 * per_epoch and resumed.step == 2 * per_epoch,
          f"steps {full.step} / {resumed.step}, want {2 * per_epoch} each")
    check(launches == steps, f"{launches} kernel launches in {steps} CLI steps")
    check(samples == steps * tc.batch_size, f"{samples} samples from the C++ engine in {steps} steps")
    check(full.skipped_steps == 0 and resumed.skipped_steps == 0, "non-finite steps")
    for ck in ("checkpoint_1", "checkpoint_2"):
        check((out / "full" / "weights" / ck).is_file(), f"{ck} missing")
    full_steps, full_ends = step_records(out / "full.jsonl")
    res_steps, _ = step_records(out / "resumed.jsonl")
    check([(r["epoch"], r["step"]) for r in full_steps]
          == [(e, i) for e in (0, 1) for i in range(per_epoch)], "per-step JSONL records")
    check(len(full_ends) == 2 and full_ends[-1]["gt_dropped_boxes"] == dropped and dropped > 0,
          f"epoch_end gt_dropped_boxes {[r['gt_dropped_boxes'] for r in full_ends]}, "
          f"overflow counters {dropped}")
    losses = lambda recs: np.array([[r["loss_cls_step"], r["loss_reg_step"]]  # noqa: E731
                                    for r in recs if r["epoch"] == 1], np.float64)
    want, got = losses(full_steps), losses(res_steps)
    check(bool(np.isfinite(losses(full_steps + res_steps)).all()), "non-finite losses")
    check(got.shape == want.shape == (per_epoch, 2), f"resumed losses {got.shape}")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(rel <= 1e-5, f"resumed epoch 1 losses differ by {rel:.3g} (rtol 1e-5)")

    img_s = [r["images_per_sec"] for r in full_ends]
    result = {
        "card": name, "steps": steps, "epochs": "2 + resumed 1", "batch": tc.batch_size,
        "ms_per_step": [1000.0 * tc.batch_size / v for v in img_s],
        "img_per_s": img_s,
        "loader_wait_ms_per_step": float(np.mean(wait_ms)),
        "loader_wait_ms_max": float(np.max(wait_ms)),
        "native_ms_per_batch_in_run": 1000.0 * native_s / (steps),
        "native_batch12_8threads_ms": float(np.median(batch_ms)),
        "peak_gib": peak / 2**30,
        "gt_dropped_boxes": dropped,
        "resumed_loss_max_rel_diff": rel,
        "first_run_wall_s": full_wall,
    }
    print(f"train CLI ResNet-101 B={tc.batch_size} 500x500 fp32, C++ engine: "
          f"{[round(v, 2) for v in result['ms_per_step']]} ms/step and "
          f"{[round(v, 2) for v in img_s]} img/s per epoch (StepTimer, step 0 excluded), "
          f"loader wait {result['loader_wait_ms_per_step']:.3f} ms/step after step 0, "
          f"C++ engine {result['native_ms_per_batch_in_run']:.1f} ms of calls per batch in the run, "
          f"{result['native_batch12_8threads_ms']:.1f} ms per batch of 12 on 8 threads alone, "
          f"peak memory {result['peak_gib']:.2f} GiB, {dropped} GT boxes dropped, "
          f"resumed losses within {rel:.2g} ({name})", flush=True)
    return result, launches


def k1_bound(b: int, y: int, x: int, t: int, g: int) -> tuple[float, str]:
    """Least time of K1 on an H100 SXM for these shapes (ms) and what bounds
    it: ~15 fp32 operations per anchor-GT pair (the +1-convention IoU, its
    division, the noise scale) at 67 TFLOP/s, against the bytes read once
    (GT, valid, templates, seeds) and written once (per-anchor max/argmax,
    per-GT max/argmax) at 3.35 TB/s."""
    ops_ms = 15.0 * b * y * x * t * g / 67e12 * 1e3
    nbytes = b * g * 16 + b * g + t * 16 + b * 4 + b * y * x * t * 8 + b * g * 8
    bytes_ms = nbytes / 3.35e12 * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this run needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}",
          flush=True)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # nvcc and the host compiler side by side
        for build in [pool.submit(assignment_kernel._kernel), pool.submit(native.load)]:
            build.result()
    print(f"build: dense_assignment.cu (nvcc) and tinyfaces_native.cpp (host C++) compiled and "
          f"loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    templates_np = load_templates()
    templates = torch.tensor(templates_np, dtype=torch.float32, device=dev)
    kres = phase_kernel(templates, dev, name)
    trainer, dataset, launches = phase_train(templates_np, dev, name)
    phase_checkpoint(trainer, dataset, templates_np, dev)
    del trainer, dataset
    torch.cuda.empty_cache()

    model, vs_cpu = phase_inference_vs_cpu(templates_np, dev)
    full = phase_full_width(model, templates_np, dev, name)
    served = phase_sweep_and_service(model, templates_np, dev)
    del model
    torch.cuda.empty_cache()
    train_cli_result, cli_launches = phase_train_cli(templates_np, dev, name)
    print(f"all phases passed in {time.perf_counter() - start:.1f} s ({name})", flush=True)
    print(json.dumps({"inference": {"card": name, "gpu_vs_cpu": vs_cpu, **full, **served}}))
    print(json.dumps({"train_cli": train_cli_result}))
    print(json.dumps({"kernels": [{
        "name": "dense_assignment_reductions",
        "route": "cuda",
        "source": "tinyfaces_tpu_torch/csrc/dense_assignment.cu",
        "replaces": "tinyfaces_tpu/ops/pallas_assignment.py:209",
        "launches": launches + cli_launches,
        "launches_by_path": {"train_epoch": launches, "train_cli": cli_launches},
        "max_abs_err": kres["max_abs_err"],
        "ms": kres["ms"],
        "plain_ms": kres["plain_ms"],
        "bound_ms": kres["bound_ms"],
        "bound_by": kres["bound_by"],
        "library_ms": None,  # no single PyTorch call computes it
    }]}))
    print(name)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

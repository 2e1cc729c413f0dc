"""Smoke run of the PyTorch/CUDA port (tinyfaces_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--against OTHER_CHECKOUT]

Phases, each printing its findings; any failure raises and exits non-zero
(`--against` also builds another checkout's K1 and times it in turns with
this one, other/this/this/other, at phase 2's timed scenes):

  0. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off, so float32 means float32;
  1. build: compiles the dense-assignment CUDA kernel, the C++ engine and
     the JPEG entropy decoder from csrc/;
  2. kernel vs its plain PyTorch twin on the card, B=12 over the 63x63x25
     anchor grid with G in {8, 192, 512}, a ragged 61x63 grid and a
     train-like batch (G 192: no GT, a crowd crop of 192, then 1-40 GTs per
     image); every image but image 0 (no valid GT) has holes in its valid
     mask. With noise off the values agree within 1e-6 and the indices
     wherever the top-2 gap exceeds 3e-6; with noise on, against the twin
     fed the kernel's own draws (kernel_noise), the values are equal and so
     are all indices; padding gives (-1, 0); with noise from another stream
     the label maps of assign_targets_fused disagree on < 0.2% of anchors.
     At the G192 and train-like scenes (the train step's shapes) the
     kernel is timed as a call from the host (`ms`, as before) and as the
     device time of a CUDA-graph replay (`device_ms`), the twin as a call
     (CUDA events, median of 20); the bound is reckoned from the timed
     inputs' valid pairs;
  3. train: Trainer.train_epoch on full ResNet-101 at batch 12, 500x500,
     fp32, default DetectorConfig, the real templates, over a seeded
     in-memory dataset; losses finite, parameters moved, the upsample
     frozen, the kernel launched on every step, and the eval output at the
     full input finite (on a copy whose BN statistics are re-estimated on
     that image);
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
     --save-every 1 --metrics-log ...` (timed, cuDNN's default
     algorithms); then, on cuDNN's deterministic algorithms (the previous
     setting restored after), the same run again and `--resume
     checkpoint_1 --epochs 2` from a fresh model; each call entered with
     TF32 on: the CLI turned TF32 off for matmuls and convolutions, every
     sample came from the C++ engine, K1 launched once per step, losses
     finite, both checkpoints written, the timed run's JSONL holds the
     per-step records and an epoch_end record whose gt_dropped_boxes is
     > 0 and equals the overflow counters, and the resumed epoch gives the
     deterministic uninterrupted run's per-step losses within rtol 1e-5
     (with the default algorithms, whose atomics change the summation
     order, the two runs of the seeded model drift apart by up to 3e-4);
  9. JPEG fixtures (tests/torch_jpeg/): every baseline and grayscale file
     entropy-decoded by csrc/jpeg_dct.cpp to the coefficients and quant
     tables whose checksums the JAX package wrote in manifest.json; the
     progressive file refused with PIL blocked, with the error that names
     its sampling, and transcoded where PIL is installed;
 10. the jpegdct reconstruction (ops/jpeg.py) of the 768x1024-bucket
     fixtures on the card against the CPU, entered with TF32 on: planes
     within 1e-3 px, normalized RGB within 6e-5;
 11. phase 5 on the jpegdct wire, from the bytes of the 240x320 grayscale
     and the 197x263 fixtures;
 12. phase 6's bf16 pyramid on the jpegdct wire, batch 32 of the
     768x1024-bucket fixtures' bytes: img/s, the split with "unpack", the
     host pack per batch (and per image on one thread), peak memory; the
     unpack alone by stage, beside the rgb wire's normalize;
 13. evaluate_model.run with the CLI's default wire (jpegdct) over a WIDER
     val tree of 40 fixture files (3 buckets), and DetectionService
     answering 16 requests of JPEG bytes (one a DCTImage) from 4 threads
     with detect_batch's results;
 14. phase 8's training through the CLI with `--transfer jpegdct` over a
     train tree of 48 fixture files at WIDER sizes, annotated by phase 8's
     generator: `--epochs 2`, entered with TF32 on; TF32 turned off, no
     sample from the C++ engine, K1 once per step, losses finite, the
     epoch_end gt_dropped_boxes > 0 and equal to the overflow counters;
     ms/step, the loader's wait once the coefficients are cached, peak
     memory;
 15. the PIL-bilinear resize (ops/pilresize.py) on the card: 28 randomised
     canvases in 7 cases (factors 0.25 to 2, true sizes inside padded
     canvases) byte-equal to the float64 host oracle, with TF32 off and
     then allowed (restored after); the three resized levels of the
     768x1024 bucket at batch 32 timed beside the linear resize, with the
     memory the float64 products take;
 16. phase 5's card-vs-CPU check and phase 6's full-width pyramid (bf16 and
     fp32) with EvalConfig(resample="pil"): the same tolerances, img/s,
     the CUDA-event split with its "resize", peak memory;
 17. the closed loop through the CLIs as child processes, under
     build/chip_smoke/e2e/: `python -m tinyfaces_tpu_torch.tools.e2e_accuracy
     --train-images 48 --val-images 16 --epochs 2` paints the trees, trains
     ResNet-101 at batch 12 (K1 once per step, counted by the child and
     reported at its end), sweeps the held-out 768x1024 images (bf16,
     jpegdct) and grades them; ap_cost runs its four configurations on the
     checkpoint; cluster_templates clusters the train tree into 25 medoids,
     which load_templates re-clusters from a missing file; the grader gives
     AP 1.0 for the val GT written as a result tree and 0.0 for an empty
     tree. Every child must exit 0 and every AP lie in [0, 1].

Phases run in the order 0-7, 9-13, 15, 16, 8, 14, 17 (9-13 and 16 need
phase 5's model).

The kernel build and the two host builds (the C++ engine, the JPEG
decoder) run side by side in phase 1. The second-to-last line of output is
the card's `nvidia-smi` name and power limit; before it, one JSON line
describes each kernel (its launches on each path, error, times, bound),
before that one JSON line holds phases 15-17's accuracy numbers, before
that one phases 9-14's jpegdct numbers, before that one phase 8's training
numbers and before that one the inference numbers; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import gc
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
from tinyfaces_tpu_torch.data import WIDERFace, jpegdct, load_templates, native, overflow
from tinyfaces_tpu_torch.data.loader import PrefetchLoader
from tinyfaces_tpu_torch.data.targets import normalize_images
from tinyfaces_tpu_torch.evaluation import PyramidDetector, _round_up, pyramid_level_sizes_np
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.ops import assignment_kernel
from tinyfaces_tpu_torch.ops import jpeg as jpeg_ops
from tinyfaces_tpu_torch.ops import pilresize
from tinyfaces_tpu_torch.ops.assignment import compose_targets, compute_pad_mask
from tinyfaces_tpu_torch.ops.resize import resize_batch
from tinyfaces_tpu_torch.serving import DetectionService
from tinyfaces_tpu_torch.trainer import Trainer, load_checkpoint, save_checkpoint
from tinyfaces_tpu_torch.utils import cuda_build

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


def graph_ms(fn, runs: int = 20) -> float:
    """Median of `runs` CUDA-event timings of one replay of fn() captured
    as a CUDA graph: the device time of fn's kernels back to back, without
    the host's time to enqueue them (which cuda_ms includes)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, runs=runs)


def scene(rng, b, g, counts=None, input_hw=(500, 500)):
    """GT boxes of 8-300 px inside the image at random slots of the padded
    list, so the valid mask has holes (zero-extent invalid boxes between the
    valid ones); counts[i] valid boxes in image i, else 1..g at random.
    Image 0 has no valid GT."""
    boxes = np.zeros((b, g, 4), np.float32)
    valid = np.zeros((b, g), bool)
    for i in range(1, b):
        n = int(counts[i]) if counts is not None else int(rng.integers(1, g + 1))
        slots = np.sort(rng.choice(g, n, replace=False))
        w, h = rng.uniform(8, 300, n), rng.uniform(8, 300, n)
        x1, y1 = rng.uniform(0, input_hw[1] - w), rng.uniform(0, input_hw[0] - h)
        boxes[i, slots] = np.stack([x1, y1, x1 + w, y1 + h], 1)
        valid[i, slots] = True
    return boxes, valid


def check_reductions(label: str, got, want, pert: torch.Tensor, valid: torch.Tensor,
                     exact: bool):
    """Kernel against twin: values within 1e-6, indices equal wherever the
    top-2 gap of `pert` (the twin's perturbed IoU) exceeds 3e-6, and the
    first-index results where nothing is valid; `exact`: values equal and
    every index equal too. Returns (max value error, share of decisive
    anchors)."""
    b, g = pert.shape[0], pert.shape[-1]
    err = max((got[0] - want[0]).abs().max().item(), (got[2] - want[2]).abs().max().item())
    top2 = pert.topk(2, dim=4).values
    decisive = top2[..., 0] - top2[..., 1] > 3e-6
    flat_top2 = pert.reshape(b, -1, g).topk(2, dim=1).values
    fdecisive = flat_top2[:, 0] - flat_top2[:, 1] > 3e-6
    gt_bad = (got[1] != want[1])[decisive].sum().item()
    idx_bad = (got[3] != want[3])[fdecisive].sum().item()
    check(err <= 1e-6, f"{label}: value error {err} > 1e-6")
    check(gt_bad == 0 and idx_bad == 0, f"{label}: {gt_bad} best_gt / {idx_bad} pgt_idx mismatches")
    if exact:
        gt_any = (got[1] != want[1]).sum().item()
        idx_any = (got[3] != want[3]).sum().item()
        check(err == 0, f"{label}: value error {err}, want 0")
        check(gt_any == 0 and idx_any == 0,
              f"{label}: {gt_any} best_gt / {idx_any} pgt_idx mismatches anywhere")
    empty = ~valid.any(1)
    check(bool((got[1][empty] == 0).all()) and bool((got[0][empty] == -1).all())
          and bool((got[3][~valid] == 0).all()) and bool((got[2][~valid] == -1).all()),
          f"{label}: padding results are not (-1, 0)")
    return err, decisive.float().mean().item()


K1_ARGTYPES = (
    [ctypes.c_void_p] * 4  # gt_boxes, gt_valid, templates, seeds
    + [ctypes.c_int] * 5  # B, G, T, Y, X
    + [ctypes.c_float] * 4  # ofx, ofy, stx, sty
    + [ctypes.c_int]  # noise
    + [ctypes.c_void_p] * 6  # best_iou, best_gt, pgt_max, pgt_idx, pgt_key, stream
)


def build_against(checkout: Path):
    """The K1 library of another checkout, compiled with this package's
    nvcc flags into build/torch_ext/; its C entry point, typed."""
    src = checkout.resolve() / "tinyfaces_tpu_torch" / "csrc" / "dense_assignment.cu"
    lib = cuda_build.BUILD_DIR / "libdense_assignment_against.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    (cuda_build.BUILD_DIR / "dense_assignment_against.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"nvcc failed for {src}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).tf_dense_assignment
    fn.restype, fn.argtypes = ctypes.c_int, K1_ARGTYPES
    return fn


def raw_k1(fn, boxes, valid, templates, seed, *, vsx, vsy, ofx, ofy, stx, sty) -> None:
    """One noise-on launch of a K1 C entry point on fresh outputs, on the
    current stream, with the same host work for every library timed in
    turns; the wrapper's launch count is not touched."""
    b, g, _ = boxes.shape
    tpl = templates[:, :4].contiguous()
    nt = tpl.shape[0]
    outs = [torch.empty(b, vsy, vsx, nt, dtype=torch.float32, device=boxes.device),
            torch.empty(b, vsy, vsx, nt, dtype=torch.int32, device=boxes.device),
            torch.empty(b, g, dtype=torch.float32, device=boxes.device),
            torch.empty(b, g, dtype=torch.int32, device=boxes.device),
            torch.zeros(b, g, dtype=torch.int64, device=boxes.device)]
    err = fn(boxes.data_ptr(), valid.data_ptr(), tpl.data_ptr(), seed.data_ptr(),
             b, g, nt, vsy, vsx, ofx, ofy, stx, sty, 1, *[o.data_ptr() for o in outs],
             torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"K1 launch in turns failed: cudaError {err}")


def phase_kernel(templates: torch.Tensor, dev: torch.device, name: str, against=None) -> dict:
    """Phase 2. `against`: another checkout's K1 entry point (build_against),
    timed in turns with this one (against, this, this, against), both
    through raw_k1, at the timed scenes."""
    rng = np.random.default_rng(0)
    cfg = DetectorConfig()
    b = TrainConfig().batch_size
    hy, hx = cfg.heatmap_size
    nt = templates.shape[0]
    train_counts = [0, cfg.max_gt, *rng.integers(1, 41, b - 2)]  # no GT, a crowd crop, 1-40
    max_err = 0.0
    result = {}
    for label, vsy, vsx, g, counts in (
            ("G8", hy, hx, 8, None), (f"G{cfg.max_gt}", hy, hx, cfg.max_gt, None),
            ("G512", hy, hx, 512, None), (f"ragged{hy - 2}x{hx}", hy - 2, hx, cfg.max_gt, None),
            ("train_like", hy, hx, cfg.max_gt, train_counts)):
        boxes_np, valid_np = scene(rng, b, g, counts)
        boxes = torch.from_numpy(boxes_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        seed = torch.arange(b, dtype=torch.int32, device=dev)
        kw = dict(vsx=vsx, vsy=vsy, **RF)
        errs, shares = [], []
        for noise in (False, True):  # noise on: the twin adds kernel_noise's draws
            got = assignment_kernel.dense_assignment_reductions(boxes, valid, templates, seed,
                                                                noise=noise, **kw)
            torch.cuda.synchronize()
            draws = assignment_kernel.kernel_noise(seed, vsy, vsx, nt, g) if noise else None
            pert = assignment_kernel.perturbed_iou(boxes, valid, templates, seed, noise=noise,
                                                   noise_tensor=draws, **kw)
            want = assignment_kernel.dense_assignment_reductions_reference(
                boxes, valid, templates, seed, noise=noise, noise_tensor=draws, **kw)
            err, share = check_reductions(f"{label} noise {'on' if noise else 'off'}", got, want,
                                          pert, valid, exact=noise)
            del pert, draws
            errs.append(err)
            shares.append(share)
        max_err = max(max_err, *errs)

        # Noise on, another stream: labels through assign_targets_fused vs the twin's composition.
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
        pairs = assignment_kernel.valid_pairs(valid, vsy, vsx, nt)
        print(f"kernel {label}: B={b} {vsy}x{vsx}x{nt} G={g}, {int(valid.sum())} of {b * g} GT "
              f"slots valid ({pairs} valid pairs): max value err noise off {errs[0]:.3g} / "
              f"on {errs[1]:.3g}, decisive anchors {shares[0]:.4f} / {shares[1]:.4f}, "
              f"noisy label mismatch {mismatch:.2e}", flush=True)

        if label in (f"G{cfg.max_gt}", "train_like"):  # the train step's shapes
            args = (boxes, valid, templates, seed)
            run = lambda: assignment_kernel.dense_assignment_reductions(*args, **kw)  # noqa: E731
            t = {"ms": cuda_ms(run), "device_ms": graph_ms(run),
                 "plain_ms": cuda_ms(
                     lambda: assignment_kernel.dense_assignment_reductions_reference(*args, **kw)),
                 "valid_pairs": pairs}
            t["bound_ms"], t["bound_by"] = assignment_kernel.k1_bound(valid, vsy, vsx, nt)
            if against is not None:
                this_fn = assignment_kernel._kernel()
                t["turns_ms"] = {"against": [], "this": []}
                t["turns_device_ms"] = {"against": [], "this": []}
                for who, fn in (("against", against), ("this", this_fn), ("this", this_fn),
                                ("against", against)):
                    call = lambda: raw_k1(fn, *args, **kw)  # noqa: E731
                    t["turns_ms"][who].append(cuda_ms(call))
                    t["turns_device_ms"][who].append(graph_ms(call))
            result[label] = t
            print(f"kernel time {label} noise on: kernel {t['ms']:.4f} ms a call from the host, "
                  f"{t['device_ms']:.4f} ms on the device (CUDA-graph replay), plain twin "
                  f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) "
                  f"(CUDA events, median of 20; {name})"
                  + (f"; in turns, ms a call {t['turns_ms']}, device ms {t['turns_device_ms']}"
                     if against is not None else ""), flush=True)
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

    # The trained detector's output at the full input, in eval mode: shape and
    # finite. On a copy whose BN running statistics are first re-estimated on
    # that image, as phase 5 calibrates: eight steps of the seeded model
    # (losses ~10^3) leave them far from the weights', and the eval output
    # then overflows in some runs (their trajectories differ by cuDNN's
    # atomics), a property of random weights, not of the port.
    x = normalize_images(torch.from_numpy(dataset[0]["image"][None]).to(dev))
    probe = copy.deepcopy(model)
    with torch.no_grad():
        for bn in probe.modules():
            if bn.__class__.__name__ == "BatchNorm2d":
                bn.momentum = 1.0
        probe(x)
        full = probe.eval()(x)
    del probe
    check(tuple(full.shape) == (1, *cfg.heatmap_size, cfg.out_channels)
          and bool(torch.isfinite(full).all()), f"forward output {tuple(full.shape)}")
    print(f"forward {tuple(x.shape)} -> {tuple(full.shape)} finite, max |out| "
          f"{full.abs().max().item():.3g} (eval, BN statistics re-estimated on the image)", flush=True)
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


def compare_with_cpu(got: list, want: list) -> dict:
    """Phase 5's check of the card's detections against the CPU's, image by
    image: finite (N, 5) rows, > 20 detections on the CPU, >= 98% of them
    paired (match_detections)."""
    out = {"pairs": 0, "unpaired": 0, "max_box_err_px": 0.0, "max_score_err": 0.0}
    for g, w in zip(got, want):
        check(g.shape[1] == 5 and np.isfinite(g).all() and len(w) > 20, f"card output {g.shape}, CPU {w.shape}")
        p, u, be, se = match_detections(g, w)
        check(p >= 0.98 * max(len(g), len(w)), f"only {p} of {len(g)}/{len(w)} detections paired")
        out["pairs"] += p
        out["unpaired"] += u
        out["max_box_err_px"] = max(out["max_box_err_px"], be)
        out["max_score_err"] = max(out["max_score_err"], se)
    return out


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
    out = compare_with_cpu(gpu.detect_batch(images), cpu.detect_batch(images))
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


def phase_full_width(calibrated: TinyFacesDetector, templates_np, dev: torch.device, name: str,
                     ec: EvalConfig = EvalConfig()):
    """Phase 6 (and phase 16 with resample="pil"): the full-width pyramid."""
    rng = np.random.default_rng(6)
    b = 32
    images = pink_images(rng, [(768, 1024)] * b)
    levels = [(192, 256), (384, 512), (768, 1024), (1536, 2048)]
    tflop = sum(conv_flops(calibrated, hw, dev) for hw in levels) / 1e12
    print(f"4-level pyramid of one 768x1024 image: {tflop:.3f} TFLOP of convolution", flush=True)
    results = {"conv_tflop_per_image": tflop, "resample": ec.resample}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", None)):
        model = TinyFacesDetector(dtype=dtype).to(dev)
        model.load_state_dict(calibrated.state_dict())
        det = PyramidDetector(model, templates_np, DetectorConfig(), ec, device=dev)
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
        print(f"pyramid {label} ResNet-101, 768x1024 bucket, batch {b}, EvalConfig() defaults, "
              f"resample={ec.resample}: "
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


def check_result_tree(out_dir: Path, n: int) -> tuple[list, int]:
    """The sweep's WIDER result files: n of them, each a header and rows of
    four integers and a score. Returns (files, detections)."""
    files = sorted(out_dir.glob("*/*.txt"))
    check(len(files) == n, f"{len(files)} result files for {n} images")
    n_dets = 0
    for f in files:
        lines = f.read_text().splitlines()
        check(lines[0] == f.stem + ".jpg" and int(lines[1]) == len(lines) - 2, f"{f}: header")
        for row in lines[2:]:
            v = row.split()
            check(len(v) == 5 and all(x.lstrip("-").isdigit() for x in v[:4]), f"{f}: row {row!r}")
            float(v[4])
        n_dets += int(lines[1])
    return files, n_dets


def serve(det: PyramidDetector, reqs: list) -> tuple[int, int]:
    """DetectionService over `det` answering `reqs` from 4 threads, each
    answer held to detect_batch's of that request alone. Returns (pairs,
    unpaired near-ties)."""
    want = [det.detect_batch([r])[0] for r in reqs]
    svc = DetectionService(det, max_batch=8, max_delay_ms=20)
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
    return pairs, unpaired


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
    files, n_dets = check_result_tree(out_dir, len(items))
    ph = evaluate_model.run.last_phases
    print(f"sweep: {len(files)} result files, {n_dets} detections, {ph['images_per_sec']:.2f} img/s "
          f"over {ph['wall']:.2f} s (bf16, 3 buckets, eval batch 32, first batch included)", flush=True)

    # Service: fp32, so the batches it forms give detect_batch's results.
    fp32 = PyramidDetector(calibrated, templates_np, DetectorConfig(), EvalConfig(), device=dev)
    pairs, unpaired = serve(fp32, pink_images(rng, [(192, 256), (300, 400)] * 8))
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
    annotation file (train_annotations)."""
    images = pink_images(rng, [TRAIN_TREE_SIZES[i % 3] for i in range(n)])
    return train_annotations(out_dir, rng, [im.shape[:2] for im in images]), images


def train_annotations(out_dir: Path, rng, sizes: list) -> Path:
    """The WIDER-format annotation file of images train_{i}.jpg of `sizes`:
    1-40 faces of 10-300 px per image, ~1000 faces of 10-20 px in the crowd
    images."""
    lines = []
    for i, (h, w) in enumerate(sizes):
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
    return ann


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
    full_steps_run, full_skipped = full.step, full.skipped_steps
    del full  # at most two models live in the deterministic pair, as in the resumed run before
    gc.collect()
    # The resume check: an uninterrupted run against one resumed from its
    # checkpoint_1, both on cuDNN's deterministic algorithms. The default
    # algorithms' atomics make two runs of the seeded model drift apart step
    # by step; the timed run above keeps the defaults a user trains with.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = cli(out / "ref", "--epochs", "2", "--save-every", "1",
                  "--metrics-log", str(out / "ref.jsonl"))
        resumed = cli(out / "resumed", "--resume", str(out / "ref" / "weights" / "checkpoint_1"),
                      "--epochs", "2", "--metrics-log", str(out / "resumed.jsonl"))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize(dev)
    launches = assignment_kernel.launch_count
    samples, native_s = native.counters["samples"], native.counters["seconds"]
    peak = torch.cuda.max_memory_allocated(dev)

    per_epoch = len(dataset) // tc.batch_size
    steps = full_steps_run + ref.step + resumed.step - per_epoch
    check(all(n == 2 * per_epoch for n in (full_steps_run, ref.step, resumed.step)),
          f"steps {full_steps_run} / {ref.step} / {resumed.step}, want {2 * per_epoch} each")
    check(launches == steps, f"{launches} kernel launches in {steps} CLI steps")
    check(samples == steps * tc.batch_size, f"{samples} samples from the C++ engine in {steps} steps")
    check(full_skipped == ref.skipped_steps == resumed.skipped_steps == 0, "non-finite steps")
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
    ref_steps, ref_ends = step_records(out / "ref.jsonl")
    want, got = losses(ref_steps), losses(res_steps)
    check(bool(np.isfinite(losses(full_steps + ref_steps + res_steps)).all()), "non-finite losses")
    check(got.shape == want.shape == (per_epoch, 2), f"resumed losses {got.shape}")
    rel = float(np.max(np.abs(got - want) / np.abs(want)))
    check(rel <= 1e-5, f"resumed epoch 1 losses differ by {rel:.3g} (rtol 1e-5)")

    img_s = [r["images_per_sec"] for r in full_ends]
    result = {
        "card": name, "steps": steps, "epochs": "2; deterministic 2 + resumed 1",
        "batch": tc.batch_size,
        "ms_per_step": [1000.0 * tc.batch_size / v for v in img_s],
        "deterministic_ms_per_step": [1000.0 * tc.batch_size / r["images_per_sec"] for r in ref_ends],
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
          f"resumed losses within {rel:.2g} (deterministic cuDNN: "
          f"{[round(v, 2) for v in result['deterministic_ms_per_step']]} ms/step) ({name})", flush=True)
    return result, launches


# --- the jpegdct wire: phases 9-14 ----------------------------------------

FIXTURES = ROOT / "tests" / "torch_jpeg"


def load_fixtures() -> dict:
    """{name: (JPEG bytes, manifest entry)} of the committed fixtures."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    return {name: ((FIXTURES / name).read_bytes(), entry) for name, entry in manifest.items()}


def in_bucket(fixtures: dict, bucket: tuple) -> list:
    """The bytes of the baseline fixtures whose canvas bucket is `bucket`."""
    return [data for data, e in fixtures.values()
            if e["kind"] != "progressive" and (_round_up(e["h"]), _round_up(e["w"])) == bucket]


def phase_jpeg_fixtures(fixtures: dict) -> dict:
    """Phase 9: every fixture decoded here, its coefficients and quant
    tables against the JAX package's checksums; the progressive file
    refused naming its sampling with PIL blocked, and transcoded where PIL
    is installed."""
    from tests.torch_jpeg.make_fixtures import coef_sha256

    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    def refusal_without_pil(data: bytes) -> str:
        saved = sys.modules.get("PIL")
        sys.modules["PIL"] = None  # `from PIL import Image` now raises ImportError
        try:
            jpegdct.parse_jpeg_dct(data)
        except jpegdct.TranscodeUnavailable as err:
            return str(err)
        finally:
            if saved is None:
                del sys.modules["PIL"]
            else:
                sys.modules["PIL"] = saved
        raise AssertionError("a progressive file decoded without PIL")

    decode_ms = {}
    for name, (data, e) in fixtures.items():
        if e["kind"] == "progressive":
            check(jpegdct.jpeg_dims(data) is None, f"{name}: the native decoder took a progressive file")
            err = refusal_without_pil(data)
            check("progressive" in err and "sampling=" in err and "needs PIL" in err, f"{name}: error {err}")
            if have_pil:
                n = jpegdct.transcode_count()
                d = jpegdct.parse_jpeg_dct(data)
                check(jpegdct.transcode_count() == n + 1 and (d.h, d.w) == (e["h"], e["w"]),
                      f"{name}: transcode")
            continue
        check(jpegdct.jpeg_dims(data) == (e["h"], e["w"]), f"{name}: header dims")
        t0 = time.perf_counter()
        d = jpegdct.parse_jpeg_dct(data)
        decode_ms[name] = 1000.0 * (time.perf_counter() - t0)
        check(coef_sha256(d) == e["coef_sha256"], f"{name}: coefficients differ from the JAX package's")
    print(f"jpeg fixtures: {len(decode_ms)} files decoded to the JAX package's coefficients, the "
          f"progressive one refused without PIL ({'and transcoded with it, PIL installed' if have_pil else 'PIL not installed'}); "
          f"entropy decode {min(decode_ms.values()):.1f}-{max(decode_ms.values()):.1f} ms a file "
          f"(one thread)", flush=True)
    return {"pil": have_pil, "decoded": len(decode_ms), "entropy_decode_ms": decode_ms}


def phase_unpack_vs_cpu(fixtures: dict, dev: torch.device) -> dict:
    """Phase 10: the wire's reconstruction on the card against the CPU on
    the fixtures of the 768x1024 bucket, entered with TF32 on: planes within
    1e-3 px, normalized RGB within 6e-5 (1e-3 px through the colour
    transform)."""
    data = in_bucket(fixtures, (768, 1024))
    b = len(data)
    wire = torch.from_numpy(jpegdct.pack_dct_batch(data, 768, 1024)["_wire"])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        fields = [jpeg_ops.wire_fields(w, 768, 1024) for w in (wire, wire.to(dev))]
        px_err = 0.0
        for p, nh, nw, z in (("y", 96, 128, jpegdct.Z_KEEP_Y), ("u", 48, 64, jpegdct.Z_KEEP_C),
                             ("v", 48, 64, jpegdct.Z_KEEP_C)):
            q = "q_y" if p == "y" else "q_c"
            want, got = (jpeg_ops.reconstruct_plane_dense(
                f[f"{p}_dc"], f[f"{p}_ac"].reshape(b, nh * nw, z), f[f"{p}_esc_idx"],
                f[f"{p}_esc_val"], f[q], nbh=nh, nbw=nw) for f in fields)
            px_err = max(px_err, (got.cpu() - want).abs().max().item())
        want = jpeg_ops.dct_batch_to_normalized({"_wire": wire}, 768, 1024)
        got = jpeg_ops.dct_batch_to_normalized({"_wire": wire.to(dev)}, 768, 1024).cpu()
        norm_err = (got - want).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    check(px_err <= 1e-3, f"card planes differ from the CPU's by {px_err} px with TF32 on")
    check(norm_err <= 6e-5, f"card normalized RGB differs from the CPU's by {norm_err} with TF32 on")
    print(f"jpegdct reconstruction card vs CPU, {b} images 768x1024, TF32 on: planes within "
          f"{px_err:.3g} px, normalized RGB within {norm_err:.3g}", flush=True)
    return {"images": b, "max_plane_err_px": px_err, "max_normalized_err": norm_err}


def phase_dct_pyramid_vs_cpu(calibrated: TinyFacesDetector, templates_np, fixtures: dict,
                             dev: torch.device) -> dict:
    """Phase 11: phase 5 on the jpegdct wire, from the bytes of the
    grayscale and the odd-sized fixtures."""
    data = [fixtures[n][0] for n in ("gray_240x320_q85.jpg", "odd_197x263_q90.jpg")]
    ec = EvalConfig(scales=(-1, 0, 1))
    gpu = PyramidDetector(calibrated, templates_np, DetectorConfig(), ec, device=dev, transfer="jpegdct")
    cpu = PyramidDetector(copy.deepcopy(calibrated).cpu(), templates_np, DetectorConfig(), ec,
                          device="cpu", transfer="jpegdct")
    out = compare_with_cpu(gpu.detect_batch(data), cpu.detect_batch(data))
    print(f"jpegdct pyramid card vs CPU, ResNet-101 fp32, fixtures 240x320 gray and 197x263, scales "
          f"(-1, 0, 1): {out['pairs']} detections paired, {out['unpaired']} unpaired near-ties, max "
          f"box error {out['max_box_err_px']:.3g} px, max score error {out['max_score_err']:.3g}",
          flush=True)
    return out


def phase_dct_full_width(calibrated: TinyFacesDetector, templates_np, fixtures: dict,
                         dev: torch.device, name: str) -> dict:
    """Phase 12: phase 6's bf16 pyramid on the jpegdct wire, from the bytes
    of the 768x1024-bucket fixtures: img/s, the CUDA-event split with
    "unpack", the host's pack per batch and per image, peak memory."""
    data = in_bucket(fixtures, (768, 1024))
    b = 32
    images = [data[i % len(data)] for i in range(b)]
    model = TinyFacesDetector(dtype=torch.bfloat16).to(dev)
    model.load_state_dict(calibrated.state_dict())
    det = PyramidDetector(model, templates_np, DetectorConfig(), EvalConfig(), device=dev,
                          transfer="jpegdct")
    pack_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        packed = det.pack_inputs(images)
        pack_ms.append(1000.0 * (time.perf_counter() - t0))
    one_ms = []
    for d in data:  # one image on one thread: the rate a pack thread keeps
        t0 = time.perf_counter()
        jpegdct.pack_dct_batch([d], 768, 1024)
        one_ms.append(1000.0 * (time.perf_counter() - t0))
    for _ in range(2):
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
        check(o.ndim == 2 and o.shape[1] == 5 and np.isfinite(o).all(), f"jpegdct bf16: output {o.shape}")
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
    # The unpack alone, by stage, against the rgb wire's normalize of a
    # canvas of the same shape (each as the pyramid runs it, to NCHW bf16).
    fields = jpeg_ops.wire_fields(packed.host.to(dev), 768, 1024)
    planes = {}

    def plane(p, nh, nw, z):
        planes[p] = jpeg_ops.reconstruct_plane_dense(
            fields[f"{p}_dc"], fields[f"{p}_ac"].reshape(b, nh * nw, z), fields[f"{p}_esc_idx"],
            fields[f"{p}_esc_val"], fields["q_y" if p == "y" else "q_c"], nbh=nh, nbw=nw)

    canvas = torch.randint(0, 256, (b, 768, 1024, 3), dtype=torch.uint8, device=dev)
    unpack_ms = {
        "luma_plane": cuda_ms(lambda: plane("y", 96, 128, jpegdct.Z_KEEP_Y)),
        "chroma_planes": cuda_ms(lambda: [plane(p, 48, 64, jpegdct.Z_KEEP_C) for p in "uv"]),
        "upsample_colour_normalize": cuda_ms(lambda: jpeg_ops.ycc_planes_to_normalized(
            planes["y"], planes["u"], planes["v"], dtype=torch.bfloat16).permute(0, 3, 1, 2).contiguous()),
        "whole": cuda_ms(lambda: jpeg_ops.dct_batch_to_normalized(
            fields, 768, 1024, dtype=torch.bfloat16).permute(0, 3, 1, 2).contiguous()),
        "rgb_normalize": cuda_ms(lambda: normalize_images(canvas, dtype=torch.bfloat16)
                                 .permute(0, 3, 1, 2).contiguous()),
    }
    del fields, planes, canvas
    r = {"img_per_s": n * b / wall, "batch_ms": 1000.0 * wall / n,
         "pack_ms_per_batch": float(np.median(pack_ms)), "pack_ms_runs": pack_ms,
         "pack_threads": jpegdct.PACK_THREADS, "pack_ms_per_image_one_thread": one_ms,
         "wire_bytes_per_image": packed.host.shape[1], "batch1_ms": float(np.median(lat[2:])),
         "peak_gib": peak, "split_ms": {k: round(v, 3) for k, v in split.items()},
         "unpack_alone_ms": unpack_ms, "dets_per_image": float(np.mean([len(o) for o in outs]))}
    print(f"pyramid jpegdct bf16 ResNet-101, 768x1024 bucket, batch {b} from {len(data)} fixtures' "
          f"bytes: {r['img_per_s']:.2f} img/s ({r['batch_ms']:.1f} ms/batch over {n} batches after 2 "
          f"warm-up), host pack {r['pack_ms_per_batch']:.1f} ms/batch on {jpegdct.PACK_THREADS} "
          f"threads ({min(one_ms):.1f}-{max(one_ms):.1f} ms an image on one), wire "
          f"{r['wire_bytes_per_image']} B/image, batch-1 latency {r['batch1_ms']:.2f} ms (pack "
          f"included), peak memory {peak:.2f} GiB ({name})", flush=True)
    print(f"  CUDA-event split of one batch (ms): {json.dumps(r['split_ms'])}", flush=True)
    print(f"  unpack alone, CUDA events, median of 20 (ms): {json.dumps(unpack_ms)}", flush=True)
    del model, det
    torch.cuda.empty_cache()
    return r


def phase_dct_sweep_and_service(calibrated: TinyFacesDetector, templates_np, fixtures: dict,
                                dev: torch.device) -> dict:
    """Phase 13: evaluate_model.run with the CLI's default wire over a WIDER
    val tree of the baseline fixtures' files (3 buckets), and the service
    answering requests of JPEG bytes and a DCTImage."""
    transfer = evaluate_model.arguments(["ann.txt"]).transfer
    check(transfer == "jpegdct", f"the sweep CLI's default wire is {transfer}")
    out = ROOT / "build" / "chip_smoke" / "val_jpeg"
    shutil.rmtree(out, ignore_errors=True)
    names = [n for n, (_, e) in fixtures.items() if e["kind"] != "progressive"]
    lines = []
    for i in range(40):
        rel = f"{i % 4}--Event{i % 4}/jpeg_{i}.jpg"
        path = out / "WIDER_val" / "images" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(fixtures[names[i % len(names)]][0])
        lines += [rel, "1", "10 10 40 40 0 0 0 0 0 0"]
    ann = out / "wider_face_val_bbx_gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    dataset = WIDERFace(ann, templates_np, split="val", dataset_root=out)
    bf16 = TinyFacesDetector(dtype=torch.bfloat16).to(dev)
    bf16.load_state_dict(calibrated.state_dict())
    det = PyramidDetector(bf16, templates_np, DetectorConfig(), EvalConfig(), device=dev, transfer=transfer)
    evaluate_model.run(det, dataset, 0.03, 0.3, "val", results_dir=out / "val_results", eval_batch=32,
                       workers=4)
    files, n_dets = check_result_tree(out / "val_results", len(dataset))
    ph = evaluate_model.run.last_phases
    print(f"sweep jpegdct: {len(files)} result files from JPEG files, {n_dets} detections, "
          f"{ph['images_per_sec']:.2f} img/s over {ph['wall']:.2f} s (bf16, 3 buckets, eval batch 32, "
          f"first batch included; pack {ph['pack']:.2f} s in all)", flush=True)
    del det, bf16

    fp32 = PyramidDetector(calibrated, templates_np, DetectorConfig(), EvalConfig(), device=dev,
                           transfer="jpegdct")
    reqs = [fixtures[n][0] for n in ("gray_240x320_q85.jpg", "odd_197x263_q90.jpg")] * 8
    reqs[3] = jpegdct.parse_jpeg_dct(reqs[3])
    pairs, unpaired = serve(fp32, reqs)
    print(f"service jpegdct: 16 requests of JPEG bytes (one a DCTImage) from 4 threads: {pairs} "
          f"detections equal detect_batch's, {unpaired} unpaired near-ties", flush=True)
    return {"sweep_img_per_s": ph["images_per_sec"], "sweep_files": len(files),
            "sweep_pack_s": ph["pack"], "service_pairs": pairs, "service_unpaired": unpaired}


def phase_train_cli_jpegdct(templates_np, fixtures: dict, dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 14: `main.run --transfer jpegdct` over a WIDER train tree whose
    48 files are the fixtures at WIDER sizes, annotated as phase 8's."""
    out = ROOT / "build" / "chip_smoke" / "train_cli_jpegdct"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    by_size: dict = {}
    for data, e in fixtures.values():
        if e["kind"] == "baseline" and (e["h"], e["w"]) in TRAIN_TREE_SIZES:
            by_size.setdefault((e["h"], e["w"]), []).append(data)
    sizes = [TRAIN_TREE_SIZES[i % 3] for i in range(48)]
    ann = train_annotations(out, np.random.default_rng(9), sizes)
    for i, hw in enumerate(sizes):
        path = out / "WIDER_train" / "images" / f"{i % 4}--Event{i % 4}" / f"train_{i}.jpg"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(by_size[hw][(i // 3) % len(by_size[hw])])
    tc = TrainConfig()

    overflow.reset()
    samples = native.counters["samples"]
    assignment_kernel.launch_count = 0
    torch.cuda.reset_peak_memory_stats(dev)
    args = train_cli.arguments([str(ann), str(ann), "--dataset-root", str(out), "--device", str(dev),
                                "--transfer", "jpegdct", "--epochs", "2", "--save-every", "2",
                                "--metrics-log", str(out / "run.jsonl")])
    # TF32 on, as cuDNN has it in a fresh process: the fp32 CLI must turn it off.
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    (out / "run").mkdir()
    t0 = time.perf_counter()
    with contextlib.chdir(out / "run"):
        trainer = train_cli.run(args)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = assignment_kernel.launch_count
    peak = torch.cuda.max_memory_allocated(dev)
    dropped = overflow.snapshot()["dropped_boxes"]

    steps = 2 * (48 // tc.batch_size)
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "the fp32 CLI left TF32 on")
    check(trainer.step == steps and launches == steps, f"{launches} kernel launches in {trainer.step} steps")
    check(native.counters["samples"] == samples, "the C++ engine augmented samples of the jpegdct wire")
    check(trainer.skipped_steps == 0, f"{trainer.skipped_steps} non-finite steps")
    check((out / "run" / "weights" / "checkpoint_2").is_file(), "checkpoint_2 missing")
    recs, ends = step_records(out / "run.jsonl")
    check(len(recs) == steps and all(np.isfinite([r["loss_cls_step"], r["loss_reg_step"]]).all()
                                     for r in recs), "per-step losses")
    check(len(ends) == 2 and ends[-1]["gt_dropped_boxes"] == dropped and dropped > 0,
          f"epoch_end gt_dropped_boxes {[r['gt_dropped_boxes'] for r in ends]}, overflow counters {dropped}")
    wait = trainer.loader_wait_ms
    del trainer
    img_s = [r["images_per_sec"] for r in ends]
    result = {"card": name, "steps": steps, "batch": tc.batch_size,
              "ms_per_step": [1000.0 * tc.batch_size / v for v in img_s], "img_per_s": img_s,
              "loader_wait_ms_epoch1_first": wait[0],
              "loader_wait_ms_epoch1_after_first": float(np.mean(wait[1:])),
              "loader_wait_ms_epoch1_max_after_first": float(np.max(wait[1:])),
              "peak_gib": peak / 2**30, "gt_dropped_boxes": dropped, "wall_s": wall}
    print(f"train CLI jpegdct ResNet-101 B={tc.batch_size} 500x500 fp32, 48 JPEG files: "
          f"{[round(v, 2) for v in result['ms_per_step']]} ms/step and {[round(v, 2) for v in img_s]} "
          f"img/s per epoch (StepTimer, step 0 excluded), loader wait in epoch 1 (coefficients "
          f"cached) {result['loader_wait_ms_epoch1_after_first']:.3f} ms/step after its first "
          f"({wait[0]:.1f} ms), peak memory {result['peak_gib']:.2f} GiB, {dropped} GT boxes dropped, "
          f"K1 launched {launches} times in {steps} steps, {wall:.1f} s in all ({name})", flush=True)
    return result, launches


# --- the accuracy path: phases 15-17 ---------------------------------------


def phase_pil_resize(dev: torch.device) -> dict:
    """Phase 15: resize_pil_batch on the card byte-equal to the float64 host
    oracle on randomised canvases (true sizes inside padded canvases, up-
    and downscales at the pyramid's factors and others), with TF32 off and
    then allowed; then the three resized levels of the 768x1024 bucket at
    batch 32 timed beside the linear resize of the same canvases."""
    rng = np.random.default_rng(15)
    cases, n_images = [], 0
    for factor in (0.25, 2**-0.5, 0.5, 2**0.5, 2.0, 0.37, 1.6):
        h0p, w0p = (int(v) for v in rng.integers(64, 320, 2))
        hs, ws = rng.integers(h0p // 2, h0p + 1, 4), rng.integers(w0p // 2, w0p + 1, 4)
        levels = pyramid_level_sizes_np(hs, ws, factor)
        out_hw = PyramidDetector._level_canvas(h0p, w0p, math.log2(factor))
        x = rng.integers(0, 256, (4, h0p, w0p, 3), dtype=np.uint8)
        want = [pilresize.resize_pil_bilinear_np(x[i, :h, :w], th, tw)
                for i, (h, w, (th, tw)) in enumerate(zip(hs, ws, levels))]
        cases.append((x, np.stack([hs, ws], 1), levels, out_hw, want))
        n_images += 4

    def check_cases(tag: str) -> None:
        for x, sizes, levels, out_hw, want in cases:
            got = pilresize.resize_pil_batch(
                torch.from_numpy(x).to(dev).permute(0, 3, 1, 2), out_hw,
                torch.from_numpy(sizes).to(dev), torch.from_numpy(levels.astype(np.int64)).to(dev))
            got = got.permute(0, 2, 3, 1).cpu().numpy()
            for i, (th, tw) in enumerate(levels):
                check(np.array_equal(got[i, :th, :tw], want[i]) and not got[i, th:].any()
                      and not got[i, :, tw:].any(),
                      f"PIL resize {tag}: {x.shape[1:3]} -> {(th, tw)} differs from the host oracle")

    check_cases("TF32 off")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        check_cases("TF32 on")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    print(f"PIL resize on the card: {n_images} canvases in {len(cases)} cases (factors 0.25-2, true "
          f"sizes inside padded canvases) byte-equal to the float64 host oracle with TF32 off and "
          f"with TF32 allowed", flush=True)

    b, size = 32, (768, 1024)
    pixels = torch.randint(0, 256, (b, 3, *size), dtype=torch.uint8, device=dev)
    canvas64 = pixels.to(torch.float64)
    normalized = normalize_images(pixels.permute(0, 2, 3, 1), dtype=torch.bfloat16)
    normalized = normalized.permute(0, 3, 1, 2).contiguous()
    sizes = torch.tensor([size] * b, device=dev)
    out = {"batch": b, "canvas": list(size), "levels": {}}
    for sexp in (-2, -1, 1):
        f = 2.0**sexp
        level = sizes.clone()
        level[:, 0], level[:, 1] = int(size[0] * f), int(size[1] * f)
        out_hw = PyramidDetector._level_canvas(*size, sexp)
        taps = (pilresize.max_taps([size[0]], [level[0, 0].item()]),
                pilresize.max_taps([size[1]], [level[0, 1].item()]))
        pil_ms = cuda_ms(lambda: pilresize.resize_pil_batch(canvas64, out_hw, sizes, level, taps),
                         runs=5, warmup=1)
        linear_ms = cuda_ms(lambda: resize_batch(normalized, out_hw, sizes, level), runs=5, warmup=1)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        pilresize.resize_pil_batch(canvas64, out_hw, sizes, level, taps)
        torch.cuda.synchronize(dev)
        extra_gib = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        # the two dense float64 products, width first
        flop = 2.0 * b * 3 * (size[0] * out_hw[1] * size[1] + out_hw[0] * out_hw[1] * size[0])
        out["levels"][f"2^{sexp}"] = {"pil_fp64_ms": pil_ms, "linear_bf16_ms": linear_ms,
                                      "pil_extra_gib": extra_gib, "pil_matmul_tflop": flop / 1e12,
                                      "pil_tflop_per_s": flop / 1e12 / (pil_ms / 1e3)}
        print(f"  resize level 2^{sexp} of the 768x1024 bucket, batch {b}: pil (float64, weights "
              f"built on the card) {pil_ms:.3f} ms, {flop / 1e12:.3f} TFLOP of matmul "
              f"({flop / 1e9 / pil_ms:.2f} TFLOP/s), {extra_gib:.2f} GiB beyond the canvas; "
              f"linear bf16 {linear_ms:.3f} ms", flush=True)
    del pixels, canvas64, normalized
    torch.cuda.empty_cache()
    out["images_checked"] = n_images
    return out


def phase_pil_pyramid(calibrated: TinyFacesDetector, templates_np, dev: torch.device, name: str) -> dict:
    """Phase 16: phase 5's card-vs-CPU check and phase 6's full-width
    pyramid with EvalConfig(resample="pil")."""
    rng = np.random.default_rng(5)
    images = pink_images(rng, [(192, 256), (176, 248)])  # phase 5's images
    ec = EvalConfig(scales=(-1, 0, 1), resample="pil")
    gpu = PyramidDetector(calibrated, templates_np, DetectorConfig(), ec, device=dev)
    cpu = PyramidDetector(copy.deepcopy(calibrated).cpu(), templates_np, DetectorConfig(), ec, device="cpu")
    vs_cpu = compare_with_cpu(gpu.detect_batch(images), cpu.detect_batch(images))
    print(f"pil pyramid card vs CPU, ResNet-101 fp32, 2 images ~192x256, scales (-1, 0, 1): "
          f"{vs_cpu['pairs']} detections paired, {vs_cpu['unpaired']} unpaired near-ties, max box "
          f"error {vs_cpu['max_box_err_px']:.3g} px, max score error {vs_cpu['max_score_err']:.3g}",
          flush=True)
    del gpu, cpu
    full = phase_full_width(calibrated, templates_np, dev, name, ec=EvalConfig(resample="pil"))
    return {"gpu_vs_cpu": vs_cpu, **full}


def run_child(log: Path, *argv: str) -> str:
    """`python -m argv...` from the checkout's root; its output goes to
    `log`, and a non-zero exit fails the phase with the log's tail."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        print("\n".join((proc.stdout + proc.stderr).splitlines()[-40:]), flush=True)
    check(proc.returncode == 0, f"{argv[0]} exited {proc.returncode}; see {log}")
    print(f"  {argv[0]}: exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return proc.stdout


def phase_closed_loop(dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 17: the closed loop through the CLIs as child processes:
    e2e_accuracy (48 train and 16 val painted images, ResNet-101, batch 12,
    2 epochs; K1 in the child on every step), ap_cost's four configurations
    on its checkpoint, cluster_templates on its train tree, and the grader
    on the val GT written as a result tree and on an empty one. Returns the
    numbers and the K1 launches the training child reports."""
    work = ROOT / "build" / "chip_smoke" / "e2e"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    run_child(work / "e2e.log", "tinyfaces_tpu_torch.tools.e2e_accuracy", "--train-images", "48",
              "--val-images", "16", "--epochs", "2", "--workdir", str(work))
    e2e = json.loads((work / "E2E_ACCURACY.json").read_text())
    steps = e2e["total_steps"]
    check(steps == 8 and e2e["k1_launches"] == steps,
          f"K1 launched {e2e['k1_launches']} times in {steps} steps of the training child")
    check(e2e["device"] == torch.cuda.get_device_name(dev), f"the eval child ran on {e2e['device']}")
    run_child(work / "ap_cost.log", "tinyfaces_tpu_torch.tools.ap_cost", "--workdir", str(work),
              "--epochs", "2")
    cost = json.loads((work / "AP_COST.json").read_text())
    aps = [e2e["ap"]] + [c["ap"] for c in cost["configs"].values()]
    check(len(cost["configs"]) == 4 and all(0.0 <= v <= 1.0 for ap in aps for v in ap.values()),
          f"APs {aps}")

    train_txt = work / "wider" / "wider_face_split" / "train.txt"
    run_child(work / "cluster.log", "tinyfaces_tpu_torch.tools.cluster_templates", str(train_txt),
              "--out", str(work / "templates.json"))
    clustered = np.asarray(json.loads((work / "templates.json").read_text()))
    check(clustered.shape == (25, 5), f"cluster_templates wrote {clustered.shape}")
    reclustered = load_templates(work / "reclustered.json", train_txt, 25)
    by_shape = lambda t: np.round(t[np.lexsort(t[:, :4].T), :4], 8)  # noqa: E731
    check(reclustered.shape == (25, 4) and np.array_equal(by_shape(reclustered), by_shape(clustered)),
          "load_templates re-clustered other medoids than cluster_templates")

    val_txt = work / "wider" / "wider_face_split" / "wider_face_val_bbx_gt.txt"
    gt_tree = work / "gt_as_results"
    n_faces = duplicates = 0
    for s in WIDERFace(val_txt, np.zeros((0, 5)), split="val").samples:
        # a box given twice in one image can match only once: AP 1.0 needs none
        duplicates += len(s.bboxes) - len(np.unique(s.bboxes, axis=0))
        rows = [f"{int(x1)} {int(y1)} {int(x2 - x1 + 1)} {int(y2 - y1 + 1)} 1.0" for x1, y1, x2, y2 in s.bboxes]
        path = gt_tree / s.img_path.replace("jpg", "txt")
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("\n".join([Path(s.img_path).name, str(len(rows)), *rows]) + "\n")
        n_faces += len(rows)
    (work / "empty_results").mkdir()
    graded = {}
    for tree, tag in ((gt_tree, "gt"), (work / "empty_results", "empty")):
        run_child(work / f"grade_{tag}.log", "tinyfaces_tpu_torch.wider_eval", str(val_txt),
                  "--results-dir", str(tree), "--out", str(work / f"grade_{tag}.json"))
        graded[tag] = json.loads((work / f"grade_{tag}.json").read_text())["scores"]
    check(duplicates == 0 and graded["gt"]["all"] == 1.0 and graded["empty"]["all"] == 0.0,
          f"grader: the GT ({duplicates} duplicate boxes) as results {graded['gt']}, an empty "
          f"tree {graded['empty']}")

    configs = {k: {"ap": v["ap"], "img_per_s": v["images_per_sec"]} for k, v in cost["configs"].items()}
    print(f"closed loop ({name}): {steps} steps (ResNet-101, batch 12, 48 painted images), loss_cls "
          f"{e2e['loss_cls_first_window']} -> {e2e['loss_cls_last_window']}, K1 {e2e['k1_launches']} "
          f"launches in the training child; AP on 16 held-out 768x1024 images (bf16 jpegdct): "
          f"{json.dumps(e2e['ap'])}; recall by height {json.dumps(e2e['recall_by_height'])}", flush=True)
    for k, v in configs.items():
        print(f"  ap_cost {k}: AP {json.dumps(v['ap'])}, {v['img_per_s']:.2f} img/s", flush=True)
    print(f"  grader: the val GT ({n_faces} faces) as a result tree AP {json.dumps(graded['gt'])}, "
          f"an empty tree {json.dumps(graded['empty'])}; cluster_templates and load_templates "
          f"re-cluster the same 25 medoids", flush=True)
    return {"card": name, "e2e": e2e, "ap_cost": configs, "grader": graded}, e2e["k1_launches"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout: its K1 is built and timed in turns with this one")
    args = ap.parse_args()
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
    builds = [assignment_kernel._kernel, native.load, jpegdct.load]
    if args.against is not None:
        builds.append(lambda: build_against(args.against))
    with ThreadPoolExecutor(len(builds)) as pool:  # nvcc and the host compiler side by side
        built = [f.result() for f in [pool.submit(build) for build in builds]]
    against = built[3] if args.against is not None else None
    print(f"build: dense_assignment.cu (nvcc), tinyfaces_native.cpp and jpeg_dct.cpp (host C++) "
          f"compiled and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    templates_np = load_templates()
    templates = torch.tensor(templates_np, dtype=torch.float32, device=dev)
    kres = phase_kernel(templates, dev, name, against)
    trainer, dataset, launches = phase_train(templates_np, dev, name)
    phase_checkpoint(trainer, dataset, templates_np, dev)
    del trainer, dataset
    torch.cuda.empty_cache()

    model, vs_cpu = phase_inference_vs_cpu(templates_np, dev)
    full = phase_full_width(model, templates_np, dev, name)
    served = phase_sweep_and_service(model, templates_np, dev)
    fixtures = load_fixtures()
    dct = {"card": name, "fixtures": phase_jpeg_fixtures(fixtures),
           "unpack_vs_cpu": phase_unpack_vs_cpu(fixtures, dev),
           "gpu_vs_cpu": phase_dct_pyramid_vs_cpu(model, templates_np, fixtures, dev),
           "bf16": phase_dct_full_width(model, templates_np, fixtures, dev, name),
           **phase_dct_sweep_and_service(model, templates_np, fixtures, dev)}
    accuracy = {"card": name, "pil_resize": phase_pil_resize(dev),
                "pil_pyramid": phase_pil_pyramid(model, templates_np, dev, name)}
    del model
    torch.cuda.empty_cache()
    train_cli_result, cli_launches = phase_train_cli(templates_np, dev, name)
    dct["train_cli"], dct_launches = phase_train_cli_jpegdct(templates_np, fixtures, dev, name)
    gc.collect()
    torch.cuda.empty_cache()  # the children of phase 17 have the card to themselves
    accuracy["closed_loop"], e2e_launches = phase_closed_loop(dev, name)
    print(f"all phases passed in {time.perf_counter() - start:.1f} s ({name})", flush=True)
    print(json.dumps({"inference": {"card": name, "gpu_vs_cpu": vs_cpu, **full, **served}}))
    print(json.dumps({"train_cli": train_cli_result}))
    print(json.dumps({"jpegdct": dct}))
    print(json.dumps({"accuracy": accuracy}))
    print(json.dumps({"kernels": [{
        "name": "dense_assignment_reductions",
        "route": "cuda",
        "source": "tinyfaces_tpu_torch/csrc/dense_assignment.cu",
        "replaces": "tinyfaces_tpu/ops/pallas_assignment.py:209",
        "launches": launches + cli_launches + dct_launches + e2e_launches,
        "launches_by_path": {"train_epoch": launches, "train_cli": cli_launches,
                             "train_cli_jpegdct": dct_launches, "e2e_train": e2e_launches},
        "max_abs_err": kres["max_abs_err"],
        **kres[f"G{DetectorConfig().max_gt}"],
        "library_ms": None,  # no single PyTorch call computes it
        "train_like": kres["train_like"],
    }]}))
    print(name)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

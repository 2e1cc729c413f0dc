"""Smoke run of the PyTorch/CUDA port (tinyfaces_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--against OTHER_CHECKOUT] [--spatial-only | --compiled-only |
                                                       --capture-only]
    python3 chip_smoke.py [--n1-against OTHER_CHECKOUT] [--e2e-against OTHER_CHECKOUT]

Phases, each printing its findings; any failure raises and exits non-zero
(`--against` also builds another checkout's K1 and times it in turns with
this one, other/this/this/other, at phase 2's timed scenes;
`--spatial-only` runs phase 26 alone after its set-up, phase 5's
calibrated model and phase 13's tree, e.g. over four cards;
`--compiled-only` runs phase 29 alone after its set-up, phase 5's
calibrated model and the JPEG fixtures; `--capture-only` runs phases 27
and 30 alone, the captured train step; `--n1-against` and
`--e2e-against` run no phase: they hold another checkout's N1 (through
its wrapper `nms_kernel._launch`, whatever its kernel's C entry point),
and its whole bench, against this one's in turns, each turn a child
process, then exit):

  0. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off, so float32 means float32;
  1. build: compiles the dense-assignment CUDA kernel K1, the NMS kernel
     N1, the C++ engine and the JPEG entropy decoder from csrc/;
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
     ResNet-101 at batch 12 on its default wire, yuv420 (K1 once per step,
     counted by the child and reported at its end), sweeps the held-out 768x1024 images (bf16,
     jpegdct) and grades them; ap_cost runs its four configurations on the
     checkpoint; cluster_templates clusters the train tree into 25 medoids,
     which load_templates re-clusters from a missing file; the grader gives
     AP 1.0 for the val GT written as a result tree and 0.0 for an empty
     tree. Every child must exit 0 and every AP lie in [0, 1].

 18. (A) phase 8's deterministic run again through `main.run` with
     `--num-processes 1 --coordinator-address file://...`, a one-rank NCCL
     group: per-step losses bit-equal to phase 8's, K1 once per step, the
     exit barrier reached with the group up;
 19. (B) world 2 at full width on one card, gloo moving the CUDA tensors:
     two child processes each take 6 rows of global batches of 12
     (ResNet-101, 500x500, fp32, deterministic cuDNN, the real templates,
     G=192) through the loader's rank slices and run 3 Trainer steps with
     nothing timed but the step, then 3 more with every collective timed
     apart; where there are 2+ cards, world = cards on NCCL, a card per
     rank, as well. The ranks' losses, parameters and BN statistics are
     bit-equal after every step. World 1 then replays each of the 3 steps
     in this process from rank 0's state before it (model, optimizer,
     step), so that every step is tests/test_parallel.py's case: losses
     within rtol 1e-5 and BN statistics 1e-4 of their largest magnitude
     at every step, parameters atol 5e-3 after steps 1 and 2 and 0.15
     after step 0 (the first step from the seeded weights is
     ill-conditioned at this depth), with world 1's replays on cuDNN's
     default algorithms and with world N's BatchNorm code printed beside
     as references; K1 launches once per rank per step; ms/step of world N and
     world 1 (the untimed-collective pass), the collectives' ms per step
     by kind, and peak memory per rank;
 20. (C) the training CLI's loop in two ranks on gloo on one card, SIGTERM
     to rank 1 alone in epoch 1: both stop after epoch 1, rank 0 writes
     the one checkpoint, both pass the exit barrier, neither hangs;
 21. (D) phase 7's sweep data-parallel over every card (one replica each)
     byte-equal to the single-card sweep of the same pieces, a warm batch
     of 32 images timed on every card and on one, and by two
     coordinated processes (a gloo group that carries the exit barrier)
     writing disjoint halves whose union is phase 7's tree byte for byte.
     Children of phases 19-21 run `python chip_smoke.py --worker ...`,
     each under a time limit.
 22. the speed instruments at full width (ResNet-101, seeded weights):
     `python -m tinyfaces_tpu_torch.bench` as a child at its defaults on
     jpegdct, rgb, yuv420 and jpegdct4, and `python -m
     tinyfaces_tpu_torch.bench_train` on rgb and yuv420 (K1 once a step),
     each ending in exactly the four-key JSON line with
     a value above 0; then in this process tools.train_bench --iters 5
     plain and --remat on deterministic cuDNN (losses within rtol 1e-5),
     profile_model, device_profile --iters 2 (CUDA kernel times and the
     idle share; at batch 1 on both wires too), pipeline_profile,
     jpegdct_ceiling in both modes at batch 32 and 1, serving_bench at
     16 and 48 requests/s for 5 s each,
     eval_sweep_bench --n 64, loader_bench and wire_stats --n 2 (v3 and v4
     columns). Each
     tool's output goes to build/chip_smoke/instruments/<tool>.log and
     the numbers to instruments.json there; a tool that raises or exits
     fails the phase. Bench's jpegdct img/s over phase 12's is printed.
 23. the folded 2x stem (ops/stemfold.py, EvalConfig's default): against
     the 2x level's resize then conv1 on 4 normalized 768x1024 canvases of
     phase 5's model, fp32 with TF32 off (borders within 2e-6, everything
     within 2e-5 + 1e-5 relative) and bf16 (0.03 of the output's scale);
     the stem alone at batch 32 bf16 (the fold, its conv NCHW and
     channels_last, the resize, resize then conv1: ms and peak memory);
     then EvalConfig() against fold_stem=False, bf16, phase 6's batch of
     32 at 768x1024, in turns (fold, resize, resize, fold): img/s, the 2x
     level's "resize 1" (the folded stem when folded) and "forward 1",
     the whole CUDA-event split, peak memory. (Phases 5, 6 and every
     pyramid with EvalConfig() fold too, on the card and on the CPU.)
 24. the yuv420 wire: phase 5 on it (card against the CPU), phase 6's
     bf16 batch of 32 on yuv420 and rgb in turns (img/s with the pack done
     before, the host pack of the planes, the split, peak memory); after
     phase 18, `main.run --transfer yuv420 --epochs 2` on phase 8's tree
     (TF32 turned off, every sample from the C++ engine and converted in
     the loader threads, K1 once a step, losses finite, ms/step, the
     loader's wait: above ~1 ms a step the step is host-bound);
 25. the jpegdct4 wire (v4, bitmap-sparse): the v4 reconstruction of the
     768x1024-bucket fixtures on the card against the CPU with TF32 on
     (phase 10's tolerances); on the card, every block whose values v4's
     stream shipped whole bit-equal to v3's reconstruction (each plane
     must have such blocks); phase 12's bf16 batch of 32 on
     jpegdct4 and jpegdct in turns: img/s, wire B/px, upload and unpack,
     host pack, truncation counts, peak memory.
 26. spatial partitioning (parallel/spatial.py): phase 5's model,
     EvalConfig() defaults, four 768x1024 images at batch 1 and 4, fp32
     (TF32 off) and bf16, PyramidDetector(shard="spatial") over every card
     (on one card, that card four times: correctness only, no speedup)
     against the unsharded pyramid: fp32 the same count and rows pairing
     at rtol 1e-4 / atol 1e-3 (else only explained near-ties unpaired at
     that tolerance, taken at the 2x level's largest coordinate); bf16
     the share of detections matched at IoU >= 0.99 and the largest score
     difference, beside the same between batch 1 and batch 4 of the
     unsharded pyramid, gated on the 1x forward's RMS error against fp32
     (split at most 1.5x unsplit); ms/image and peak memory per card; then
     shard="batch" over the same devices, one image a replica, fp32: the
     eager call, the capture and a replay bit-equal to the eager path, one
     graph per replica with its pool on its own card; then
     `evaluate_model.main --fp32 --debug` on phase 13's tree unsharded,
     with `--data-parallel --shard auto` and with `--shard spatial`, the
     result files paired with the unsharded run's;
 27. make_multi_train_step: K=4, ResNet-101 batch 12, 500x500, fp32,
     deterministic cuDNN with its timed engine search, three calls
     (warm-up step, capture and 3 replays; then 2 replays, a capture at
     the learning rate the staircase steps down to at step 6, 2 replays;
     then batch 8: a warm-up step at the new shape, a capture and 2
     replays) against 12 plain train steps from the same state with the
     same draws: losses, parameters, BN statistics and momentum bit-equal
     or within rtol 1e-6 (printed), K1 once a step, each call's seconds
     printed; then tools.train_bench --multi 4 --iters 3 and its plain
     step in the same process;
 28. tools.h2d_probe (16 MiB payloads), tools.prewarm_cache (every
     library, cached by then) and tools.kernel_selftest (K1 against the
     plain assignment on the card: PASS).
 30. Trainer.train_step's captured route (trainer._CapturedSteps, next to
     27): ResNet-101 500x500, fp32, deterministic cuDNN with its timed
     engine search, a Trainer's first 8 steps (at batch 12 a warm-up
     step, a capture and 5 replays; at batch 8 a warm-up step, a capture
     and its replay) against 8 eager train_step calls from the same
     weights and the same step generators, while another thread pins and
     copies host memory as the loader's producer does: the losses each
     step returned (kept until the last step), parameters, BN statistics
     and momentum bit-equal or within rtol 1e-6 (the largest gap
     printed), step_counts {"eager": 2, "captured": 2, "replayed": 6,
     "tuned": 2} and the tuned steps' seconds printed, K1 once a step;
     then, on default cuDNN, the step with a loss read after each (as the
     benchmark's train cell reads it), eager and replayed in turns (eager,
     replay, replay, eager, 5 steps each, ms a step); then one `main.run --profile-dir`
     epoch (4 steps) on the phase's own 48-image tree, the capture under
     the profiler: its trace.json holds K1's kernel once a step, its
     spans.json the steps' paths (eager, capture, replay, replay).
 29. the compiled pyramid and N1 (phase 5's model, EvalConfig(), the
     768x1024 bucket): (b) per wire setting (rgb, jpegdct, jpegdct4,
     yuv420, rgb with resample="pil"), fp32 (TF32 off) and bf16, batch 1
     and 32, the replayed CUDA graph's packed output against the eager
     path's on the same inputs, bit-equal in fp32, in bf16 reported with
     its share matched at IoU >= 0.99; the captures' seconds, graphs and
     pool bytes; (c) at batch 1 one replay and one eager call under
     torch.cuda.set_sync_debug_mode("error"); (a) N1 against
     nms_blocked_reference and the plain fixpoint, keep masks bit-equal, on
     (b)'s decode outputs at batch 32 and 1 (bf16, fp32), synthetic
     scenes (valid counts 0, 1, 63, 64, 65, N; equal scores; zero-area
     boxes; a suppression chain 200 deep), 4000 rows all valid at batch
     32, invalid rows interleaved below valid ones, NaN coordinates, N =
     33 and 4001, and N = 16,000 past the rows staged in shared memory,
     thresholds 0.3 and 0.5; N1 timed (a call, a graph replay) beside the
     plain keep step and the blocked reference at B = 32 and 1 and on the
     all-valid batch, with nms_bound; (d) on jpegdct
     bf16, the eager path (trace set) and the replayed one: host launch
     calls, device launches and busy share per batch-1 call
     (tools.device_profile's trace), batch-1 latency (median of 20), b32
     img/s, peak memory, DetectionService p50/p95/p99 at 16 req/s for 5 s
     (tools.serving_bench), the captures and the pool; (e) at the reference
     precision and the CLI's eval batch (fp32, TF32 off, eval batch 32):
     one 768x1024 key's eager call and capture with the pool's bytes and
     the allocator's peak after each, bit-equal outputs, then
     evaluate_model.run over that bucket and then a 1024x768 one, three
     batches of 32 each, so the second bucket's eager first call runs
     beside the first one's captured graph: both keys captured, no release
     for memory, the result tree, the pool and the peak.

On a GPU every pyramid replays its CUDA graph (evaluation.PyramidDetector)
from a key's second call on (its first runs eagerly in the graphs' pool),
except where a trace is set: the CUDA-event splits of phases 6, 12, 16 and
23-25 are of the eager path, and phase 26's split pyramid runs eagerly.

Phases run in the order 0-4, 19, 20, 5-7, 21, 9-13, 15, 16, 23, 24, 25, 26,
29, 8, 18, 24's training, 14, 17, 22, 27, 30, 28 (9-13, 16, 21, 23-26 and 29
need phase 5's model, 26 and 29 phase 13's fixtures, 18 and 24's training
phase 8's tree and run, 22 phase 12's rate).

The kernel build and the two host builds (the C++ engine, the JPEG
decoder) run side by side in phase 1. The second-to-last line of output is
the card's `nvidia-smi` name and power limit; before it, one JSON line
describes each kernel (its launches on each path, error, times, bound),
before that one holds phase 29's numbers ("compiled_pyramid"), before that
one phases 26-28's ("spatial_multi_tools"),
before that one JSON line holds phase 22's instrument numbers, before that
one phases 23-25's ("wires"), before that
one phases 18-21's multi-process numbers, before that one phases 15-17's
accuracy numbers, before that one phases
9-14's jpegdct numbers, before that one phase 8's
training numbers and before that one the inference numbers; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import ctypes
import gc
import hashlib
import inspect
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from tinyfaces_tpu_torch import evaluate_model
from tinyfaces_tpu_torch import main as train_cli
from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig, TrainConfig
from tinyfaces_tpu_torch.data import WIDERFace, jpegdct, load_templates, native, overflow
from tinyfaces_tpu_torch.data.loader import PrefetchLoader
from tinyfaces_tpu_torch.data.targets import normalize_images
from tinyfaces_tpu_torch.evaluation import PyramidDetector, _round_up, pyramid_level_sizes_np
from tinyfaces_tpu_torch.models import resnet
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.ops import assignment_kernel, nms_kernel
from tinyfaces_tpu_torch.ops import nms as nms_ops
from tinyfaces_tpu_torch.ops import jpeg as jpeg_ops
from tinyfaces_tpu_torch.ops import pilresize
from tinyfaces_tpu_torch.ops.assignment import compose_targets, compute_pad_mask
from tinyfaces_tpu_torch.ops.resize import resize_batch
from tinyfaces_tpu_torch.parallel import distributed
from tinyfaces_tpu_torch.parallel.mesh import local_devices
from tinyfaces_tpu_torch.parallel.spatial import spatial_forward
from tinyfaces_tpu_torch.serving import DetectionService
from tinyfaces_tpu_torch.tools import (device_profile, eval_sweep_bench, jpegdct_ceiling,
                                       loader_bench, pipeline_profile, profile_model,
                                       serving_bench, train_bench, wire_stats)
from tinyfaces_tpu_torch.trainer import Trainer, load_checkpoint, save_checkpoint
from tinyfaces_tpu_torch import bench as bench_mod
from tinyfaces_tpu_torch.utils.instruments import build_detector as instrument_detector
from tinyfaces_tpu_torch.utils import cuda_build, profiling

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


def capture_graph(fn) -> torch.cuda.CUDAGraph:
    """fn() captured as a CUDA graph, after three warm-up calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capturing stream, as capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def graph_ms(fn, runs: int = 20) -> float:
    """Median of `runs` CUDA-event timings of one replay of fn() captured
    as a CUDA graph: the device time of fn's kernels back to back, without
    the host's time to enqueue them (which cuda_ms includes)."""
    return cuda_ms(capture_graph(fn).replay, runs=runs)


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
        # peak from the first call on: a replayed graph allocates nothing, its capture does
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(2):  # warm-up: the eager first call (cuDNN's set-up), the capture
            det._fetch(det.detect_batch_async(packed))
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
              f"{r['img_per_s']:.2f} img/s ({r['batch_ms']:.1f} ms/batch over {n} replayed batches "
              f"after 2 warm-up; host pack {pack_ms:.1f} ms/batch not included), batch-1 latency "
              f"{r['batch1_ms']:.2f} ms (replayed, median of 5, pack included), peak memory {peak:.2f} GiB, "
              f"{r['dets_per_image']:.1f} detections/image ({name})", flush=True)
        print(f"  CUDA-event split of one batch on the eager path (ms): {json.dumps(r['split_ms'])}",
              flush=True)
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


SWEEP_DIR = ROOT / "build" / "chip_smoke" / "val_results"


def sweep_items(rng) -> list:
    """Phase 7's 64 (image, img_path) items of mixed sizes (3 buckets)."""
    sizes = [(300, 400)] * 24 + [(480, 360)] * 24 + [(200, 300)] * 16
    return [(im, f"{i % 4}--Event{i % 4}/smoke_{i}.jpg")
            for i, im in enumerate(pink_images(rng, sizes))]


def bf16_copy(calibrated: TinyFacesDetector, dev: torch.device) -> TinyFacesDetector:
    bf16 = TinyFacesDetector(dtype=torch.bfloat16).to(dev)
    bf16.load_state_dict(calibrated.state_dict())
    return bf16


def phase_sweep_and_service(calibrated: TinyFacesDetector, templates_np, dev: torch.device):
    rng = np.random.default_rng(7)
    items = sweep_items(rng)
    out_dir = SWEEP_DIR
    shutil.rmtree(out_dir, ignore_errors=True)
    det = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                          device=dev)
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


def epoch_waits_ms(spans: list) -> list:
    """The consumer's waits on the loader's queue (its `loader.get` spans)
    in the last epoch recorded, ms, in order."""
    gets = [s for s in spans if s.name == "loader.get"]
    first = max(i for i, s in enumerate(gets) if s.attrs["first"])
    return [1e3 * (s.end - s.start) for s in gets[first:]]


def run_train_cli(ann: Path, dataset, dev: torch.device, run_dir: Path, *extra: str):
    """`main.run` over `dataset` in `run_dir` with the CLI's defaults and
    `extra`, entered with TF32 on (as cuDNN has it in a fresh process): the
    fp32 CLI must turn it off. Returns the Trainer."""
    run_dir.mkdir()
    args = train_cli.arguments([str(ann), str(ann), "--device", str(dev), *extra])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    with contextlib.chdir(run_dir):  # weights/ goes under the run's directory
        trainer = train_cli.run(args, dataset)
    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "the fp32 CLI left TF32 on")
    return trainer


def phase_train_cli(templates_np, dev: torch.device, name: str) -> tuple[dict, int, Path, WIDERFace]:
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
        return run_train_cli(ann, dataset, dev, run_dir, *extra)

    overflow.reset()
    native.counters.update(samples=0)
    assignment_kernel.launch_count = 0
    torch.cuda.reset_peak_memory_stats(dev)
    profiling.reset()
    profiling.enable()  # the loader's waits and the C++ engine's calls, as spans
    t0 = time.perf_counter()
    full = cli(out / "full", "--epochs", "2", "--save-every", "1",
               "--metrics-log", str(out / "full.jsonl"))
    full_wall = time.perf_counter() - t0
    dropped = overflow.snapshot()["dropped_boxes"]
    wait_ms = epoch_waits_ms(profiling.spans())[1:]
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
    profiling.enable(False)
    samples = native.counters["samples"]
    native_s = sum(s.end - s.start for s in profiling.spans() if s.name == "loader.augment")
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
    return result, launches, ann, dataset


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
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)  # from the first call on, the capture included
    for _ in range(2):
        det._fetch(det.detect_batch_async(packed))
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
    profiling.reset()
    profiling.enable()
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
    profiling.enable(False)
    wait = epoch_waits_ms(profiling.spans())
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
    check(steps == 8 and e2e["k1_launches"] == steps and e2e["train_transfer"] == "yuv420",
          f"K1 launched {e2e['k1_launches']} times in {steps} steps of the training child "
          f"(wire {e2e['train_transfer']}, the tool's default yuv420)")
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


# --- the speed instruments: phase 22 ----------------------------------------

INSTRUMENTS_DIR = ROOT / "build" / "chip_smoke" / "instruments"
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def run_bench(module: str, metric: str, log: Path, **env: str) -> dict:
    """`python -m module` at its defaults (BENCH_* from `env` only) as a
    child: exit 0, a last stdout line of exactly the contract's four keys
    with `metric` and a value above 0. Returns the child's detail line
    (the last JSON line of its stderr) with the contract line under
    "line"."""
    t0 = time.perf_counter()
    child_env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", module], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**child_env, **env})
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        print("\n".join((proc.stdout + proc.stderr).splitlines()[-40:]), flush=True)
    check(proc.returncode == 0, f"{module} {env} exited {proc.returncode}; see {log}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    check(set(line) == BENCH_KEYS and line["metric"] == metric and line["value"] > 0,
          f"{module} {env}: last line {line}")
    detail = json.loads([ln for ln in proc.stderr.splitlines() if ln.startswith("{")][-1])
    print(f"  {module} {env or ''}: {json.dumps(line)} in {time.perf_counter() - t0:.1f} s", flush=True)
    return {**detail, "line": line}


def run_tool(name: str, main, argv: list):
    """A tool's CLI in this process (`main(argv)`), its output to a log;
    a raise or an exit fails the phase with the log's tail."""
    log = INSTRUMENTS_DIR / f"{name}.log"
    t0 = time.perf_counter()
    with open(log, "w") as f, contextlib.redirect_stdout(f):
        try:
            out = main(argv)
        except (Exception, SystemExit) as e:
            f.flush()
            print("\n".join(log.read_text().splitlines()[-30:]), flush=True)
            raise AssertionError(f"{name} {argv} failed: {e!r}; see {log}") from e
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {name} {' '.join(argv)}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def phase_instruments(dev: torch.device, name: str, phase12_img_per_s: float) -> tuple[dict, int]:
    """Phase 22: the speed instruments at full width. Both benches as
    children at their defaults (bench on jpegdct, rgb, yuv420 and
    jpegdct4; bench_train on rgb and yuv420); then every tool in this
    process with shortened durations. Returns the headline numbers and K1's
    launches (bench_train's timed steps on both wires, train_bench's two
    runs)."""
    t_phase = time.perf_counter()
    shutil.rmtree(INSTRUMENTS_DIR, ignore_errors=True)
    INSTRUMENTS_DIR.mkdir(parents=True)
    out: dict = {"card": name}
    metric = "pyramid_inference_images_per_sec_per_chip"
    out["bench"] = {t: run_bench("tinyfaces_tpu_torch.bench", metric, INSTRUMENTS_DIR / f"bench_{t}.log",
                                 **({"BENCH_TRANSFER": t} if t != "jpegdct" else {}))
                    for t in ("jpegdct", "rgb", "yuv420", "jpegdct4")}
    launches = 0
    for t in ("rgb", "yuv420"):
        r = run_bench("tinyfaces_tpu_torch.bench_train", "train_step_images_per_sec_per_chip",
                      INSTRUMENTS_DIR / f"bench_train_{t}.log",
                      **({"BENCH_TRANSFER": t} if t != "rgb" else {}))
        check(r["transfer"] == t and r["k1_launches"] == r["steps"] + 1, f"bench_train {t}: K1 "
              f"{r['k1_launches']} launches in {r['steps']} timed steps and the warm-up")
        launches += r["k1_launches"]
        out["bench_train" + ("" if t == "rgb" else f"_{t}")] = r
    train, train_yuv = out["bench_train"], out["bench_train_yuv420"]

    # train_bench plain and --remat on deterministic cuDNN: the same losses
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        runs = {tag: run_tool(f"train_bench{tag}", train_bench.main, ["--iters", "5", *extra])
                for tag, extra in (("", []), ("_remat", ["--remat"]))}
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    plain, remat = runs[""], runs["_remat"]
    for r in runs.values():
        check(r["k1_launches"] == r["iters"] + r["warmup_steps"] and np.isfinite(r["losses"]).all(),
              f"train_bench: K1 {r['k1_launches']} launches in {r['iters']} steps and the warm-up, "
              f"losses {r['losses']}")
        launches += r["k1_launches"]
    rel = float(np.max(np.abs(np.subtract(remat["losses"], plain["losses"]))
                       / np.abs(plain["losses"])))
    check(rel <= 1e-5, f"train_bench --remat losses {remat['losses']} vs plain {plain['losses']}")
    out["train_bench"] = {"plain": plain, "remat": remat, "remat_loss_rel_diff": rel}

    out["profile_model"] = run_tool("profile_model", profile_model.main, [])
    out["device_profile"] = run_tool("device_profile", device_profile.main,
                                     ["--iters", "2", "--out-dir", str(INSTRUMENTS_DIR / "trace")])
    check(out["device_profile"]["device_ms"] > 0, "device_profile: no device time")
    # batch 1 on both wires: how much of a single image's latency the device is busy
    out["device_profile_b1"] = {
        t: run_tool(f"device_profile_b1_{t}", device_profile.main,
                    ["--batch", "1", "--iters", "5", "--transfer", t, "--top", "5",
                     "--out-dir", str(INSTRUMENTS_DIR / f"trace_b1_{t}")])
        for t in ("jpegdct", "rgb")}
    out["pipeline_profile"] = run_tool("pipeline_profile", pipeline_profile.main, [])
    out["jpegdct_ceiling"] = {
        f"{mode}_b{b}": run_tool(f"jpegdct_ceiling_{mode}_b{b}", jpegdct_ceiling.main,
                                 ["--mode", mode, "--batch", str(b), "--iters", "6"])
        for b in (32, 1) for mode in ("device", "upload")}
    rows = run_tool("serving_bench", serving_bench.main,
                    ["--loads", "16,48", "--duration", "5", "--out", str(INSTRUMENTS_DIR / "serving.json")])
    check(len(rows) == 2 and all(r["n"] > 0 and r["p50_ms"] > 0 for r in rows), f"serving rows {rows}")
    out["serving_bench"] = rows
    out["eval_sweep_bench"] = run_tool("eval_sweep_bench", eval_sweep_bench.main,
                                       ["--n", "64", "--root", str(INSTRUMENTS_DIR / "sweep")])
    out["loader_bench"] = run_tool("loader_bench", loader_bench.main,
                                   ["--root", str(INSTRUMENTS_DIR / "loader")])
    ws = run_tool("wire_stats", wire_stats.main, ["--n", "2", "--json"])
    check(len(ws) == 16 and all(r["v3_Bpx"] > r["v4_Bpx"] > 0 for r in ws.values()), "wire_stats rows")
    out["wire_stats"] = {k: ws[k] for k in ("natural/q90", "texture/q95")}
    out["bench_jpegdct_over_phase12"] = out["bench"]["jpegdct"]["value"] / phase12_img_per_s
    out["phase_s"] = time.perf_counter() - t_phase

    b, dp, pp = out["bench"], out["device_profile"], out["pipeline_profile"]
    for t, r in b.items():
        lat = r["batch1"]
        print(f"bench {t}: {r['value']:.2f} img/s (windows {[round(x, 2) for x in r['window_rates']]}), "
              f"{r['wire_Bpx']:.3f} B/px, H2D probe {r['h2d_probe_MiBps']:.0f} MiB/s, warm-up "
              f"{r['warmup_s']:.1f} s, peak {r['peak_gib']:.2f} GiB, {r['tflops']:.1f} TFLOP/s "
              f"({100 * (r['share_of_peak'] or 0):.1f}% of bf16 peak); batch-1 {lat['total_ms']:.2f} ms = "
              f"pack {lat['pack_ms']:.2f} + enqueue {lat['enqueue_ms']:.2f} + wait {lat['wait_ms']:.2f} "
              f"(replayed graph); eager path (traced) {lat['eager_total_ms']:.2f} ms: upload "
              f"{lat['eager_upload_ms']:.2f}, device {lat['eager_device_ms']:.2f} (CUDA events)", flush=True)
    print(f"bench jpegdct / phase 12's pyramid in this run: {out['bench_jpegdct_over_phase12']:.3f}", flush=True)
    print(f"bench_train yuv420: {train_yuv['value']:.2f} img/s (windows "
          f"{[round(x, 2) for x in train_yuv['window_rates']]}), peak {train_yuv['peak_gib']:.2f} GiB, "
          f"K1 {train_yuv['k1_launches']}", flush=True)
    print(f"bench_train: {train['value']:.2f} img/s (windows {[round(x, 2) for x in train['window_rates']]}), "
          f"peak {train['peak_gib']:.2f} GiB, {train['tflops']:.2f} TFLOP/s fp32, K1 {train['k1_launches']}; "
          f"train_bench plain {plain['ms_per_step']:.1f} / remat {remat['ms_per_step']:.1f} ms/step "
          f"(deterministic cuDNN), peak {plain['peak_gib']:.2f} / {remat['peak_gib']:.2f} GiB, "
          f"losses equal within {rel:.1e}", flush=True)
    print(f"device_profile (jpegdct bf16 b32): {dp['device_ms_per_batch']:.1f} ms/batch of device time, "
          f"busy {100 * dp['busy_share']:.1f}%, idle {100 * dp['idle_share']:.1f}%; classes "
          + json.dumps({k: round(v, 4) for k, v in dp["class_share"].items()}), flush=True)
    for k in dp["top_kernels"][:8]:
        print(f"  {k['ms_per_batch']:8.2f} ms {100 * k['share']:5.1f}%  {k['name'][:100]}", flush=True)
    for t, r in out["device_profile_b1"].items():
        print(f"device_profile {t} b1: {r['device_ms_per_batch']:.2f} ms of device time in "
              f"{r['window_ms'] / r['iters']:.2f} ms a batch, busy {100 * r['busy_share']:.1f}%, "
              f"{r['launches_per_batch']:.0f} device launches and {r['host_launches_per_batch']:.0f} host "
              f"launch calls a batch (replayed graph)", flush=True)
    print(f"profile_model: {out['profile_model']['pyramid_flops_per_image'] / 1e12:.4f} TFLOP/image, "
          f"train step {out['profile_model']['train_step_flops'] / 1e12:.4f} TFLOP", flush=True)
    print(f"pipeline_profile (rgb b16): prep {pp['host_prep_ms']:.2f}, H2D {pp['h2d_ms']:.2f} ms "
          f"({pp['h2d_MiBps']:.0f} MiB/s), compute {pp['device_compute_ms']:.2f}, D2H {pp['d2h_ms']:.3f}, "
          f"serial {pp['serial_ms']:.2f} ms; depth 1-4 img/s "
          f"{[round(v['img_per_s'], 2) for v in pp['pipelined'].values()]}", flush=True)
    for k, r in out["jpegdct_ceiling"].items():
        print(f"jpegdct_ceiling {k}: {r['ms_per_batch']:.2f} ms/batch = {r['img_per_s']:.2f} img/s ({r['clock']})"
              + (f", reconstruction {r['reconstruction_ms']:.2f} ms" if "reconstruction_ms" in r else ""),
              flush=True)
    for r in rows:
        print(f"serving {r['offered_load']:.0f}/s: achieved {r['achieved']}, n {r['n']}, p50 {r['p50_ms']} "
              f"p95 {r['p95_ms']} p99 {r['p99_ms']} max {r['max_ms']} ms", flush=True)
    sw = out["eval_sweep_bench"]
    print(f"eval_sweep_bench (n 64): pipelined {sw['pipelined']['img_per_s']:.2f}, sync-batch "
          f"{sw['sync-batch']['img_per_s']:.2f}, per-image {sw['per-image']['img_per_s']:.2f} img/s", flush=True)
    lb = out["loader_bench"]
    print(f"loader_bench: python {lb['python']['samples_per_s']:.1f}, native {lb['native']['samples_per_s']:.1f} "
          f"samples/s ({lb['native_speedup']:.2f}x); wire_stats natural/q90 v3 "
          f"{out['wire_stats']['natural/q90']['v3_Bpx']:.3f} / v4 "
          f"{out['wire_stats']['natural/q90']['v4_Bpx']:.3f} B/px, drops v3 "
          f"{out['wire_stats']['natural/q90']['v3_drop_pct']:.3f}% / v4 "
          f"{out['wire_stats']['natural/q90']['v4_drop_pct']:.3f}%; texture/q95 v4 drops "
          f"{out['wire_stats']['texture/q95']['v4_drop_pct']:.2f}%", flush=True)
    print(f"phase 22 (instruments) took {out['phase_s']:.1f} s ({name})", flush=True)
    (INSTRUMENTS_DIR / "instruments.json").write_text(json.dumps(out, indent=1))
    for r in (dp, *out["device_profile_b1"].values()):
        r["top_kernels"] = r["top_kernels"][:5]  # the whole ranking stays in the file
    return out, launches


# --- the folded stem and the yuv420 and jpegdct4 wires: phases 23-25 ------


def timed_pyramid(det: PyramidDetector, packed, n: int = 3) -> dict:
    """One PackedBatch through det n times after 2 warm-up runs (the first
    runs eagerly, the second captures the graph): img/s, ms/batch (host clock), peak memory from the
    first call on, the finite outputs, and the CUDA-event split of one more
    batch on the eager path, every phase apart."""
    dev = det.devices[0]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)  # from the first call on, the capture included
    for _ in range(2):
        det._fetch(det.detect_batch_async(packed))
    t0 = time.perf_counter()
    for _ in range(n):
        outs = det._fetch(det.detect_batch_async(packed))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    for o in outs:
        check(o.ndim == 2 and o.shape[1] == 5 and np.isfinite(o).all(), f"{det.transfer}: output {o.shape}")
    start = torch.cuda.Event(enable_timing=True)
    det.trace = [("start", start)]
    start.record()
    det._fetch(det.detect_batch_async(packed))
    split = {phase: a.elapsed_time(b) for (_, a), (phase, b) in zip(det.trace, det.trace[1:])}
    det.trace = None
    b = packed.hs.shape[0]
    return {"img_per_s": n * b / wall, "batch_ms": 1000.0 * wall / n, "peak_gib": peak,
            "split_ms": {k: round(v, 3) for k, v in split.items()},
            "dets_per_image": float(np.mean([len(o) for o in outs]))}


def in_turns(dets: dict, packed: dict, rounds: int = 2) -> dict:
    """timed_pyramid of each detector in turns, A B B A for two, `rounds`
    times each; per label the list of runs."""
    labels = list(dets)
    order = (labels + labels[::-1]) * (rounds // 2) + (labels if rounds % 2 else [])
    runs: dict = {k: [] for k in labels}
    for k in order:
        runs[k].append(timed_pyramid(dets[k], packed[k]))
    return runs


def summary(runs: list) -> dict:
    """Medians over in_turns' runs of one label (the split per phase)."""
    keys = runs[0]["split_ms"].keys()
    return {"img_per_s": [r["img_per_s"] for r in runs],
            "batch_ms": float(np.median([r["batch_ms"] for r in runs])),
            "peak_gib": max(r["peak_gib"] for r in runs),
            "split_ms": {k: round(float(np.median([r["split_ms"][k] for r in runs])), 3) for k in keys},
            "dets_per_image": runs[-1]["dets_per_image"]}


def phase_fold(calibrated: TinyFacesDetector, templates_np, dev: torch.device, name: str) -> dict:
    """Phase 23: the folded 2x stem on the card. (a) folded_stem_2x against
    the 2x level's resize then conv1 on 4 normalized 768x1024 canvases of
    the calibrated model's stem, fp32 with TF32 off (borders atol 2e-6,
    everything atol 2e-5 / rtol 1e-5) and bf16 (0.03 of the output's
    scale), the CPU test's tolerances; (b) the stem alone (stem_alone);
    (c) EvalConfig() (the fold) against fold_stem=False at batch 32 bf16
    in turns: img/s, the 2x level's "resize 1" and "forward 1", peak
    memory."""
    from tinyfaces_tpu_torch.ops.stemfold import folded_stem_2x

    check(not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32,
          "phase 23 compares fp32 with TF32 on")
    rng = np.random.default_rng(23)
    images = pink_images(rng, [(768, 1024)] * 4)
    x = normalize_images(torch.from_numpy(np.stack(images)).to(dev)).permute(0, 3, 1, 2).contiguous()
    w7 = calibrated.model.conv1.weight.detach()
    size = torch.tensor([[768, 1024]] * 4, device=dev)
    errs = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        xd = x.to(dtype)
        with torch.no_grad():
            want = F.conv2d(resize_batch(xd, (1536, 2048), size, 2 * size), w7.to(dtype), stride=2,
                            padding=3).float()
            got = folded_stem_2x(xd, w7).float()
        check(got.shape == want.shape == (4, 64, 768, 1024), f"fold {label}: {tuple(got.shape)}")
        diff = (got - want).abs()
        scale = float(want.abs().max())
        border = max(float(diff[:, :, :2].max()), float(diff[:, :, -2:].max()),
                     float(diff[..., :2].max()), float(diff[..., -2:].max()))
        errs[label] = {"max_abs_err": float(diff.max()), "border_max_abs_err": border, "scale": scale,
                       "max_excess_over_rtol": float((diff - 1e-5 * want.abs()).max())}
        if label == "fp32":
            check(border <= 2e-6 and errs[label]["max_excess_over_rtol"] <= 2e-5,
                  f"fold fp32 against resize+conv1: border {border:.3g} (atol 2e-6), everywhere "
                  f"{errs[label]['max_excess_over_rtol']:.3g} beyond rtol 1e-5 (atol 2e-5)")
        else:
            check(float(diff.max()) <= 0.03 * scale, f"fold bf16: {float(diff.max()):.3g} > 0.03 x {scale:.3g}")
        del want, got, diff
    del x
    torch.cuda.empty_cache()
    print(f"folded stem against the 2x resize then conv1, 4 canvases 768x1024: fp32 (TF32 off) "
          f"borders within {errs['fp32']['border_max_abs_err']:.3g}, everywhere "
          f"{errs['fp32']['max_abs_err']:.3g} (scale {errs['fp32']['scale']:.3g}); bf16 "
          f"{errs['bf16']['max_abs_err']:.3g} (0.03 x scale = {0.03 * errs['bf16']['scale']:.3g})",
          flush=True)

    images = pink_images(np.random.default_rng(6), [(768, 1024)] * 32)  # phase 6's batch
    alone = stem_alone(images, w7, dev)
    dets, packed = {}, {}
    for label, fold in (("fold", True), ("resize", False)):
        ec = EvalConfig(fold_stem=fold)
        dets[label] = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), ec,
                                      device=dev)
        packed[label] = dets[label].pack_inputs(images)
    runs = in_turns(dets, packed)
    out = {"card": name, "stem_vs_resize_conv1": errs, "stem_alone": alone,
           **{k: summary(v) for k, v in runs.items()}}
    del dets, packed
    torch.cuda.empty_cache()
    for k in ("fold", "resize"):
        r, s = out[k], out[k]["split_ms"]
        print(f"pyramid bf16 b32 768x1024 {'EvalConfig() (folded stem)' if k == 'fold' else 'fold_stem=False'}: "
              f"{[round(v, 2) for v in r['img_per_s']]} img/s in turns, 2x level: resize "
              f"{s['resize 1']:.3f} ms (the folded stem when folded) + forward {s['forward 1']:.3f} ms, "
              f"peak {r['peak_gib']:.2f} GiB ({name})", flush=True)
        print(f"  CUDA-event split (ms, median of the turns): {json.dumps(s)}", flush=True)
    return out


def stem_alone(images: list, w7: torch.Tensor, dev: torch.device) -> dict:
    """The 2x level's stem alone on a batch of 32 768x1024 canvases, bf16:
    CUDA-event ms (median of 10) and the peak memory above the canvas of
    the folded stem, its 5x5 conv alone (NCHW, as the pyramid runs it, and
    channels_last), the exact-2x resize, and the resize then conv1."""
    from tinyfaces_tpu_torch.ops.stemfold import fold_stem_kernel, folded_stem_2x

    x = normalize_images(torch.from_numpy(np.stack(images)).to(dev), dtype=torch.bfloat16)
    x = x.permute(0, 3, 1, 2).contiguous()
    x_cl = x.contiguous(memory_format=torch.channels_last)
    k5 = fold_stem_kernel(w7).to(torch.bfloat16)
    size = torch.tensor([[768, 1024]] * len(images), device=dev)
    w7b = w7.to(torch.bfloat16)
    variants = {
        "folded_stem_2x": lambda: folded_stem_2x(x, w7),
        "fold_conv_nchw": lambda: F.conv2d(x, k5, padding=2),
        "fold_conv_channels_last": lambda: F.conv2d(x_cl, k5.contiguous(memory_format=torch.channels_last),
                                                    padding=2),
        "resize_2x": lambda: resize_batch(x, (1536, 2048), size, 2 * size),
        "resize_2x_then_conv1": lambda: F.conv2d(resize_batch(x, (1536, 2048), size, 2 * size), w7b,
                                                 stride=2, padding=3),
    }
    out = {}
    with torch.no_grad():
        for k, fn in variants.items():
            ms = cuda_ms(fn, runs=10)
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            y = fn()
            torch.cuda.synchronize(dev)
            out[k] = {"ms": ms, "peak_gib_above_inputs": (torch.cuda.max_memory_allocated(dev) - base) / 2**30}
            del y
    del x, x_cl
    torch.cuda.empty_cache()
    print("  the 2x stem alone, b32 768x1024 bf16 (CUDA events, median of 10; peak above the canvas): "
          + "; ".join(f"{k} {v['ms']:.3f} ms, {v['peak_gib_above_inputs']:.2f} GiB" for k, v in out.items()),
          flush=True)
    return out


def phase_yuv420(calibrated: TinyFacesDetector, templates_np, dev: torch.device, name: str) -> dict:
    """Phase 24 (pyramid half): phase 5 on the yuv420 wire (card against
    the CPU), then phase 6's bf16 batch of 32 at 768x1024 on yuv420 and rgb
    in turns: img/s with the pack done before, the split, the host pack
    (the planes' conversion on 4 threads) per batch, peak memory."""
    images = pink_images(np.random.default_rng(5), [(192, 256), (176, 248)])  # phase 5's
    ec = EvalConfig(scales=(-1, 0, 1))
    gpu = PyramidDetector(calibrated, templates_np, DetectorConfig(), ec, device=dev, transfer="yuv420")
    cpu = PyramidDetector(copy.deepcopy(calibrated).cpu(), templates_np, DetectorConfig(), ec,
                          device="cpu", transfer="yuv420")
    vs_cpu = compare_with_cpu(gpu.detect_batch(images), cpu.detect_batch(images))
    del gpu, cpu
    print(f"yuv420 pyramid card vs CPU, ResNet-101 fp32, phase 5's images: {vs_cpu['pairs']} "
          f"detections paired, {vs_cpu['unpaired']} unpaired near-ties, max box error "
          f"{vs_cpu['max_box_err_px']:.3g} px, max score error {vs_cpu['max_score_err']:.3g}", flush=True)

    images = pink_images(np.random.default_rng(6), [(768, 1024)] * 32)
    dets, packed, pack_ms = {}, {}, {}
    for t in ("yuv420", "rgb"):
        dets[t] = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                                  device=dev, transfer=t)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            packed[t] = dets[t].pack_inputs(images)
            times.append(1000.0 * (time.perf_counter() - t0))
        pack_ms[t] = float(np.median(times))
    runs = in_turns(dets, packed)
    out = {"gpu_vs_cpu": vs_cpu, "wire_bytes_per_image": {t: packed[t].host[0].numel() for t in packed}}
    for t in ("yuv420", "rgb"):
        out[t] = {**summary(runs[t]), "pack_ms_per_batch": pack_ms[t]}
    del dets, packed
    torch.cuda.empty_cache()
    for t in ("yuv420", "rgb"):
        r = out[t]
        print(f"pyramid bf16 b32 768x1024 on {t}: {[round(v, 2) for v in r['img_per_s']]} img/s in turns "
              f"(pack before), unpack {r['split_ms']['unpack']:.3f} ms, upload {r['split_ms']['upload']:.3f} "
              f"ms, host pack {r['pack_ms_per_batch']:.1f} ms/batch, wire "
              f"{out['wire_bytes_per_image'][t]} B/image, peak {r['peak_gib']:.2f} GiB ({name})", flush=True)
    return out


def phase_train_cli_yuv420(ann: Path, dataset, dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 24 (training half): `main.run --transfer yuv420 --epochs 2` on
    phase 8's tree, entered with TF32 on: TF32 turned off, every sample from
    the C++ engine and then converted to planes in the loader threads, K1
    once a step, losses finite; ms/step and the loader's wait (above ~1 ms a
    step the step is host-bound)."""
    out = ROOT / "build" / "chip_smoke" / "train_cli_yuv420"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    tc = TrainConfig()
    native.counters.update(samples=0)
    assignment_kernel.launch_count = 0
    torch.cuda.reset_peak_memory_stats(dev)
    profiling.reset()
    profiling.enable()
    t0 = time.perf_counter()
    trainer = run_train_cli(ann, dataset, dev, out / "run", "--transfer", "yuv420", "--epochs", "2",
                            "--save-every", "2", "--metrics-log", str(out / "run.jsonl"))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = assignment_kernel.launch_count
    steps = 2 * (len(dataset) // tc.batch_size)
    check(trainer.transfer == "yuv420" and trainer.step == steps and launches == steps,
          f"yuv420 CLI: {launches} kernel launches in {trainer.step} steps, want {steps}")
    check(native.counters["samples"] == steps * tc.batch_size,
          f"{native.counters['samples']} samples from the C++ engine in {steps} steps")
    check(trainer.skipped_steps == 0, f"{trainer.skipped_steps} non-finite steps")
    recs, ends = step_records(out / "run.jsonl")
    check(len(recs) == steps and all(np.isfinite([r["loss_cls_step"], r["loss_reg_step"]]).all()
                                     for r in recs), "yuv420 CLI: per-step losses")
    check((out / "run" / "weights" / "checkpoint_2").is_file(), "yuv420 CLI: checkpoint_2 missing")
    profiling.enable(False)
    wait = epoch_waits_ms(profiling.spans())[1:]
    del trainer
    gc.collect()
    img_s = [r["images_per_sec"] for r in ends]
    res = {"card": name, "steps": steps, "ms_per_step": [1000.0 * tc.batch_size / v for v in img_s],
           "img_per_s": img_s, "loader_wait_ms_per_step": float(np.mean(wait)),
           "loader_wait_ms_max": float(np.max(wait)), "host_bound": bool(np.mean(wait) > 1.0),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30, "wall_s": wall}
    print(f"train CLI yuv420 ResNet-101 B={tc.batch_size} 500x500 fp32 on phase 8's tree: "
          f"{[round(v, 2) for v in res['ms_per_step']]} ms/step, {[round(v, 2) for v in img_s]} img/s "
          f"per epoch, loader wait {res['loader_wait_ms_per_step']:.3f} ms/step in epoch 2 (max "
          f"{res['loader_wait_ms_max']:.2f}; "
          + ("above 1 ms: the step is host-bound" if res["host_bound"] else "the step is not host-bound")
          + f"), K1 {launches} launches in {steps} steps, peak {res['peak_gib']:.2f} GiB ({name})", flush=True)
    return res, launches


def phase_jpegdct4(calibrated: TinyFacesDetector, templates_np, fixtures: dict, dev: torch.device,
                   name: str) -> dict:
    """Phase 25: the jpegdct4 wire. (a) The v4 reconstruction of the
    768x1024-bucket fixtures on the card against the CPU, entered with TF32
    on: planes within 1e-3 px, normalized RGB within 6e-5 (phase 10's);
    (b) on the card, every block whose values v4's stream shipped whole
    reconstructs to v3's pixels bit for bit (the noisy fixtures overflow
    the stream, so some blocks lose their tail); (c) phase 12's bf16 batch
    of 32 on jpegdct4 and jpegdct in turns: img/s, the split, host pack,
    wire B/px, truncation."""
    data = in_bucket(fixtures, (768, 1024))
    b = len(data)
    wire = torch.from_numpy(jpegdct.pack_dct_batch(data, 768, 1024, wire_version=4)["_wire"])
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        fields = [jpeg_ops.wire_fields(w, 768, 1024, version=4) for w in (wire, wire.to(dev))]
        px_err = 0.0
        for p, nh, nw, z in (("y", 96, 128, jpegdct.Z_KEEP_Y), ("u", 48, 64, jpegdct.Z_KEEP_C),
                             ("v", 48, 64, jpegdct.Z_KEEP_C)):
            q = "q_y" if p == "y" else "q_c"
            want, got = (jpeg_ops.reconstruct_plane_sparse(
                f[f"{p}_dc"], f[f"{p}_bm"], f[f"{p}_vals"], f[f"{p}_esc_idx"], f[f"{p}_esc_val"], f[q],
                nbh=nh, nbw=nw, z=z, order=f["h0w0"][:, 2] if p == "y" else None) for f in fields)
            px_err = max(px_err, (got.cpu() - want).abs().max().item())
        want = jpeg_ops.dct4_batch_to_normalized({"_wire": wire}, 768, 1024)
        got = jpeg_ops.dct4_batch_to_normalized({"_wire": wire.to(dev)}, 768, 1024).cpu()
        norm_err = (got - want).abs().max().item()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    check(px_err <= 1e-3 and norm_err <= 6e-5,
          f"v4 reconstruction card vs CPU: planes {px_err} px, normalized {norm_err} (TF32 on)")

    # (b) v4 keeps a prefix of each plane's value stream: a block whose
    # values all made it into the stream (its popcount equals the number
    # of nonzero ACs v3 ships for it) must reconstruct to v3's pixels.
    w3 = torch.from_numpy(jpegdct.pack_dct_batch(data, 768, 1024)["_wire"]).to(dev)
    f3 = jpeg_ops.wire_fields(w3, 768, 1024)
    f4 = fields[1]
    complete = {}
    for p, nh, nw, z in (("y", 96, 128, jpegdct.Z_KEEP_Y), ("u", 48, 64, jpegdct.Z_KEEP_C),
                         ("v", 48, 64, jpegdct.Z_KEEP_C)):
        q = "q_y" if p == "y" else "q_c"
        ac = f3[f"{p}_ac"].reshape(b, nh * nw, z)
        r3 = jpeg_ops.reconstruct_plane_dense(f3[f"{p}_dc"], ac, f3[f"{p}_esc_idx"], f3[f"{p}_esc_val"],
                                              f3[q], nbh=nh, nbw=nw)
        r4 = jpeg_ops.reconstruct_plane_sparse(f4[f"{p}_dc"], f4[f"{p}_bm"], f4[f"{p}_vals"],
                                               f4[f"{p}_esc_idx"], f4[f"{p}_esc_val"], f4[q], nbh=nh,
                                               nbw=nw, z=z, order=f4["h0w0"][:, 2] if p == "y" else None)
        whole = jpeg_ops._popcount32(f4[f"{p}_bm"]) == (ac != 0).sum(-1)  # (b, blocks)
        blocks = lambda r: r.view(b, nh, 8, nw, 8).permute(0, 1, 3, 2, 4).reshape(b, nh * nw, 64)  # noqa: E731
        check(torch.equal(blocks(r3)[whole], blocks(r4)[whole]),
              f"v4 plane {p}: blocks with every value shipped differ from v3's reconstruction")
        complete[p] = [int(whole.sum()), whole.numel()]
        check(complete[p][0] > 0, f"v4 plane {p}: no block shipped whole")
    del w3, f3, f4, fields
    print(f"jpegdct4 reconstruction card vs CPU, {b} images 768x1024, TF32 on: planes within "
          f"{px_err:.3g} px, normalized RGB within {norm_err:.3g}; on the card bit-equal to v3's in every "
          f"block v4 shipped whole (blocks whole / all, Y Cb Cr: {complete})", flush=True)

    images = [data[i % b] for i in range(32)]
    dets, packed, pack_ms, trunc = {}, {}, {}, {}
    for t in ("jpegdct4", "jpegdct"):
        dets[t] = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                                  device=dev, transfer=t)
        times = []
        for _ in range(3):
            before = jpegdct.truncation_stats()
            t0 = time.perf_counter()
            packed[t] = dets[t].pack_inputs(images)
            times.append(1000.0 * (time.perf_counter() - t0))
            after = jpegdct.truncation_stats()
        pack_ms[t] = float(np.median(times))
        trunc[t] = {k: after[k] - before[k] for k in after}
    runs = in_turns(dets, packed)
    out = {"card": name, "unpack_vs_cpu": {"images": b, "max_plane_err_px": px_err,
                                           "max_normalized_err": norm_err},
           "blocks_bit_equal_to_v3": complete}
    for t in ("jpegdct4", "jpegdct"):
        out[t] = {**summary(runs[t]), "pack_ms_per_batch": pack_ms[t],
                  "wire_Bpx": packed[t].host.shape[1] / (768 * 1024),
                  "truncation_per_batch": trunc[t]}
    del dets, packed
    torch.cuda.empty_cache()
    for t in ("jpegdct4", "jpegdct"):
        r = out[t]
        print(f"pyramid bf16 b32 768x1024 on {t} from the fixtures' bytes: "
              f"{[round(v, 2) for v in r['img_per_s']]} img/s in turns, wire {r['wire_Bpx']:.4f} B/px, "
              f"upload {r['split_ms']['upload']:.3f} ms, unpack {r['split_ms']['unpack']:.3f} ms, host "
              f"pack {r['pack_ms_per_batch']:.1f} ms/batch, truncation per batch "
              f"{r['truncation_per_batch']}, peak {r['peak_gib']:.2f} GiB ({name})", flush=True)
    return out


# --- multi-process training and evaluation: phases 18-21 (A-D) -----------

DIST_DIR = ROOT / "build" / "chip_smoke" / "dist"
DIST_STEPS = 3  # phase 19's checked train steps per rank; as many again with the collectives timed
STOP_IMAGES = 12  # phase 20's train tree: one step of 12 per epoch


def fresh_store(name: str) -> str:
    """A `file://` init address whose file does not exist yet."""
    DIST_DIR.mkdir(parents=True, exist_ok=True)
    path = DIST_DIR / f"{name}.store"
    path.unlink(missing_ok=True)
    return f"file://{path}"


def spawn_ranks(tag: str, argvs: list, timeout: int = 300) -> list[str]:
    """One child `python chip_smoke.py --worker ...` per argv, started
    together; each child's output goes to DIST_DIR/<tag>_<rank>.log. A
    child that exits non-zero or is still running at `timeout` fails the
    phase; every child is stopped before this returns."""
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for argv in argvs:
            logs.append(DIST_DIR / f"{tag}_{len(logs)}.log")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()), "--worker", *argv],
                    cwd=ROOT, stdout=log, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print("\n".join(out.splitlines()[-40:]), flush=True)
        check(p.returncode == 0, f"{tag} rank {r} exited {p.returncode} (killed at the {timeout} s "
                                 f"limit if negative); see {logs[r]}")
    print(f"  {tag}: {len(procs)} ranks exit 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    return outs


def phase_world1_group(ann: Path, dataset, dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 18 (A): phase 8's deterministic run again through `main.run`
    with `--num-processes 1 --coordinator-address file://...`, an NCCL
    group of one rank: its per-step losses are bit-equal to phase 8's, K1
    launches once per step, and the run leaves through the exit barrier
    with the group up."""
    out = ROOT / "build" / "chip_smoke" / "train_cli"
    shutil.rmtree(out / "world1", ignore_errors=True)
    (out / "world1.jsonl").unlink(missing_ok=True)
    barriers = []
    real_barrier = distributed.barrier_at_exit

    def spy(label: str) -> None:
        barriers.append((label, dist.is_initialized() and dist.get_backend(),
                         dist.is_initialized() and dist.get_world_size()))
        real_barrier(label)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    distributed.barrier_at_exit = spy
    assignment_kernel.launch_count = 0
    t0 = time.perf_counter()
    try:
        trainer = run_train_cli(ann, dataset, dev, out / "world1", "--epochs", "2", "--save-every", "1",
                                "--metrics-log", str(out / "world1.jsonl"), "--num-processes", "1",
                                "--coordinator-address", fresh_store("world1"))
    finally:
        distributed.barrier_at_exit = real_barrier
        torch.backends.cudnn.deterministic = deterministic
    torch.cuda.synchronize(dev)
    launches = assignment_kernel.launch_count
    wall = time.perf_counter() - t0
    check(barriers == [("train_done", "nccl", 1)] and not dist.is_initialized(),
          f"exit barriers {barriers}, group still up: {dist.is_initialized()}")
    check(launches == trainer.step == 2 * (len(dataset) // trainer.tc.batch_size),
          f"{launches} K1 launches in {trainer.step} steps")
    pairs = lambda recs: [(r["epoch"], r["step"], r["loss_cls_step"], r["loss_reg_step"])  # noqa: E731
                          for r in recs]
    got, want = pairs(step_records(out / "world1.jsonl")[0]), pairs(step_records(out / "ref.jsonl")[0])
    check(got == want, f"world-1 group losses differ from phase 8's deterministic run: {got} vs {want}")
    print(f"world 1 through the CLI on an NCCL group: {trainer.step} steps, losses bit-equal to "
          f"phase 8's deterministic run, K1 {launches} launches, exit barrier reached "
          f"({wall:.1f} s; {name})", flush=True)
    return {"steps": trainer.step, "losses_bit_equal": True, "wall_s": wall}, launches


def dist_trainer(dev: torch.device | str, rank: int, world: int) -> tuple[Trainer, PrefetchLoader]:
    """Phase 19's trainer and loader on one rank: full-width ResNet-101
    (seeded weights, fp32), global batches of 12 at 500x500 with G=192
    (make_dataset), this rank's rows of each."""
    cfg, tc = DetectorConfig(), TrainConfig()
    dataset = make_dataset(cfg, DIST_STEPS * tc.batch_size, seed=11)
    model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0))
    trainer = Trainer(model, cfg, tc, load_templates(), device=dev, seed=0, augment="python")
    trainer.setup(steps_per_epoch=DIST_STEPS)
    loader = PrefetchLoader(dataset, tc.batch_size, device=trainer.device, workers=4, seed=5,
                            rank=rank, world=world)
    return trainer, loader


def host_state(trainer: Trainer) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in trainer.model.state_dict().items()}


def timed_step(trainer: Trainer, batch: dict) -> tuple[list, float]:
    """One Trainer.train_step: its three losses and host ms. Under a group
    every rank starts the clock together (rank 0 keeps more state between
    steps, and the others would time their wait for it)."""
    torch.cuda.synchronize(trainer.device)
    if distributed.world() > 1:
        distributed.barrier()
    t0 = time.perf_counter()
    lb = trainer.train_step(batch)
    losses = [x.item() for x in lb]  # waits for the step
    return losses, 1000.0 * (time.perf_counter() - t0)


def worker_dist_steps(store: str, world: str, rank: str, backend: str, out: str) -> None:
    """Phase 19's work on one rank of world N, on deterministic cuDNN:
    DIST_STEPS steps with nothing timed but the step, recording per step
    the losses, host ms and a digest of the parameters and buffers, and on
    rank 0 the state before each step (model, optimizer, step); then the
    next epoch's DIST_STEPS steps with every collective bracketed by device
    syncs (distributed.comm_ms), recording their ms by kind."""
    torch.backends.cudnn.deterministic = True
    rank_, world_ = int(rank), int(world)
    distributed.initialize(store, world_, rank_, backend=backend, device="cuda")
    trainer, loader = dist_trainer("cuda", rank_, world_)
    assignment_kernel.launch_count = 0
    torch.cuda.reset_peak_memory_stats(trainer.device)
    res = {"losses": [], "ms": [], "digests": [], "before": [], "comm_ms": [], "comm_step_ms": []}
    for batch in loader:
        if rank_ == 0:
            res["before"].append({"model": host_state(trainer), "step": trainer.step,
                                  "optimizer": copy.deepcopy(trainer.opt.state_dict())})
        losses, ms = timed_step(trainer, batch)
        res["losses"].append(losses)
        res["ms"].append(ms)
        state = host_state(trainer)
        res["digests"].append(hashlib.sha256(b"".join(v.numpy().tobytes() for v in state.values()))
                              .hexdigest())
        if rank_ == 0:
            res["after"] = state
    distributed.comm_ms = {}
    try:
        for batch in loader:
            before = dict(distributed.comm_ms)
            res["comm_step_ms"].append(timed_step(trainer, batch)[1])
            res["comm_ms"].append({k: v - before.get(k, 0.0) for k, v in distributed.comm_ms.items()})
    finally:
        distributed.comm_ms = None
    res.update(launches=assignment_kernel.launch_count, steps=trainer.step,
               rows=int(batch["flip"].shape[0]),
               peak_gib=torch.cuda.max_memory_allocated(trainer.device) / 2**30)
    torch.save(res, out)
    distributed.barrier_at_exit("dist_steps_done")


class GlobalBatchNormOneRank:
    """Stands in for `parallel.distributed` in models/resnet.py: one
    process takes world N's BatchNorm path (the merge of every rank's
    statistics, autograd's backward) over its whole batch."""

    world = staticmethod(lambda: 2)
    rank = staticmethod(lambda: 0)
    all_reduce_sum = staticmethod(lambda x: x)


def replay_world1(dev: torch.device, payloads: list, deterministic: bool,
                  global_bn: bool = False) -> dict:
    """World 1 of phase 19: each global batch's step on this process's card
    from world N's state before it (model, optimizer, step), so that every
    step is tests/test_parallel.py's case, one step from one state. Per
    step the losses, host ms and the state after. `global_bn` runs world
    N's BatchNorm code in place of cuDNN's."""
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = deterministic
    if global_bn:
        resnet.distributed = GlobalBatchNormOneRank
    try:
        trainer, loader = dist_trainer(dev, 0, 1)
        assignment_kernel.launch_count = 0
        torch.cuda.reset_peak_memory_stats(dev)
        res = {"losses": [], "ms": [], "after": []}
        for batch, payload in zip(loader, payloads, strict=True):
            trainer.restore(copy.deepcopy(payload))  # the optimizer may alias host tensors
            losses, ms = timed_step(trainer, batch)
            res["losses"].append(losses)
            res["ms"].append(ms)
            res["after"].append(host_state(trainer))
        res.update(launches=assignment_kernel.launch_count,
                   peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30)
    finally:
        torch.backends.cudnn.deterministic = previous
        resnet.distributed = distributed
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return res


def state_diff(a: dict, b: dict) -> tuple[float, float]:
    """Largest |a - b| over the parameters, and over the BN statistics as a
    fraction of each tensor's largest magnitude (at least 1)."""
    param_err = bn_err = 0.0
    for k, v in a.items():
        err = float((b[k] - v).abs().max())
        if k.endswith(("running_mean", "running_var")):
            bn_err = max(bn_err, err / max(1.0, float(b[k].abs().max())))
        else:
            param_err = max(param_err, err)
    return param_err, bn_err


def step_diffs(a: dict, b: dict) -> dict:
    """Per step: the largest relative difference of the three losses, and
    state_diff of the states after it."""
    diffs = [state_diff(x, y) for x, y in zip(a["after"], b["after"])]
    return {"losses": [float(np.max(np.abs(np.subtract(x, y)) / np.abs(y)))
                       for x, y in zip(a["losses"], b["losses"])],
            "param": [d[0] for d in diffs], "bn": [d[1] for d in diffs]}


# World N against world 1, one step from the same state, at every step.
DIST_LOSS_RTOL = 1e-5  # tests/test_parallel.py's
DIST_BN_RTOL = 1e-4  # of each tensor's largest magnitude (at least 1): its atol 1e-4
DIST_PARAM_ATOL = 5e-3  # steps 1 and 2; tests/test_parallel.py's 5e-5 widened, see compare_world
STEP0_PARAM_ATOL = 0.15  # the first step from the seeded weights, see compare_world


def compare_world(tag: str, ranks: list, dev: torch.device) -> dict:
    """The ranks' losses, parameters and BN statistics bit-equal to each
    other after every step; then world 1 replays every step from rank 0's
    state before it (replay_world1) on deterministic cuDNN, and twice more
    for reference: on cuDNN's default algorithms, and with world N's
    BatchNorm code in one process. World N against the deterministic
    replay, at every step: losses within DIST_LOSS_RTOL, BN statistics
    DIST_BN_RTOL, parameters DIST_PARAM_ATOL, except after the first step
    from the seeded weights, STEP0_PARAM_ATOL. That step's backward is
    ill-conditioned at this depth: swapping world 1's cuDNN BatchNorm for
    world N's code in one process moves the stem's update (3.3) by ~0.06,
    where cuDNN's other algorithms move any parameter by ~8e-4; from the
    next state on, both references and world N agree to ~5e-4."""
    for r in ranks[1:]:
        check(r["losses"] == ranks[0]["losses"], f"{tag}: the ranks' losses differ")
        check(r["digests"] == ranks[0]["digests"], f"{tag}: the ranks' parameters or buffers differ")
    world_n = {"losses": ranks[0]["losses"],
               "after": [b["model"] for b in ranks[0]["before"][1:]] + [ranks[0]["after"]]}
    one = replay_world1(dev, ranks[0]["before"], deterministic=True)
    default = replay_world1(dev, ranks[0]["before"], deterministic=False)
    own_bn = replay_world1(dev, ranks[0]["before"], deterministic=True, global_bn=True)
    noise, bn_code = step_diffs(default, one), step_diffs(own_bn, one)
    got = step_diffs(world_n, one)
    fmt = lambda v: [f"{x:.3g}" for x in v]  # noqa: E731
    print(f"  {tag} against world 1, one step from the same state at each of {DIST_STEPS} steps: "
          f"losses {fmt(got['losses'])} rel, parameters {fmt(got['param'])}, BN statistics "
          f"{fmt(got['bn'])} of their largest magnitude; world 1 against itself on default cuDNN: "
          f"losses {fmt(noise['losses'])}, parameters {fmt(noise['param'])}, BN statistics "
          f"{fmt(noise['bn'])}; with world N's BatchNorm code: losses {fmt(bn_code['losses'])}, "
          f"parameters {fmt(bn_code['param'])}, BN statistics {fmt(bn_code['bn'])}", flush=True)
    bounds = [STEP0_PARAM_ATOL] + [DIST_PARAM_ATOL] * (DIST_STEPS - 1)
    check(max(got["losses"]) <= DIST_LOSS_RTOL and max(got["bn"]) <= DIST_BN_RTOL
          and all(p <= b for p, b in zip(got["param"], bounds)),
          f"{tag}: against world 1, losses {fmt(got['losses'])} (rtol {DIST_LOSS_RTOL}), parameters "
          f"{fmt(got['param'])} (atol {bounds}), BN statistics {fmt(got['bn'])} (rtol {DIST_BN_RTOL})")
    check(all(r["launches"] == r["steps"] == 2 * DIST_STEPS for r in ranks) and one["launches"] == DIST_STEPS,
          f"{tag}: K1 launches per rank {[r['launches'] for r in ranks]} in {2 * DIST_STEPS} steps, "
          f"world 1 {one['launches']} in {DIST_STEPS}")
    step_ms = float(np.median([m for r in ranks for m in r["ms"][1:]]))
    one_ms = float(np.median(one["ms"][1:]))
    kinds = sorted({k for r in ranks for c in r["comm_ms"] for k in c})
    comm = {k: float(np.median([c.get(k, 0.0) for r in ranks for c in r["comm_ms"]])) for k in kinds}
    timed_ms = float(np.median([m for r in ranks for m in r["comm_step_ms"]]))
    return {"world": len(ranks), "rows_per_rank": ranks[0]["rows"], "ms_per_step": step_ms,
            "img_per_s": 1000.0 * TrainConfig().batch_size / step_ms,
            "world1_ms_per_step": one_ms, "world1_img_per_s": 1000.0 * TrainConfig().batch_size / one_ms,
            "world1_peak_gib": one["peak_gib"],
            "comm_ms_per_step": comm, "comm_timed_ms_per_step": timed_ms,
            "comm_share_of_timed_step": sum(comm.values()) / timed_ms,
            "vs_world1": got, "world1_default_cudnn_vs_deterministic": noise,
            "world1_global_bn_code_vs_cudnn_bn": bn_code,
            "launches_per_rank": [r["launches"] for r in ranks],
            "world1_replay_launches": one["launches"] + default["launches"] + own_bn["launches"],
            "peak_gib_per_rank": [r["peak_gib"] for r in ranks]}


def phase_world_n(dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 19 (B): world 2 on gloo with the tensors on the card (so two
    ranks may share one) and, where there are 2+ cards, world = cards on
    NCCL with a card per rank; each against world 1 of the same global
    batches replayed step by step (compare_world)."""
    result, launches = {"card": name}, 0
    cards = torch.cuda.device_count()
    runs = [("gloo", 2)] + ([("nccl", cards)] if cards >= 2 and 12 % cards == 0 else [])
    for backend, world in runs:
        tag = f"{backend}_world{world}"
        store = fresh_store(tag)
        outs = [DIST_DIR / f"{tag}_{r}.pt" for r in range(world)]
        spawn_ranks(tag, [["dist_steps", store, str(world), str(r), backend, str(outs[r])]
                          for r in range(world)])
        res = compare_world(tag, [torch.load(o, weights_only=True, map_location="cpu") for o in outs],
                            dev)
        launches += sum(res["launches_per_rank"]) + res["world1_replay_launches"]
        result[tag] = res
        print(f"world {world} on {backend} ({'one card' if backend == 'gloo' else 'a card per rank'}): "
              f"{res['rows_per_rank']} rows per rank, ranks bit-equal, every step held to world 1; "
              f"{res['ms_per_step']:.2f} ms/step ({res['img_per_s']:.2f} img/s) against world 1's "
              f"{res['world1_ms_per_step']:.2f} (deterministic cuDNN, nothing else timed); with the "
              f"collectives timed apart, {res['comm_timed_ms_per_step']:.2f} ms/step of which "
              f"{json.dumps({k: round(v, 3) for k, v in res['comm_ms_per_step'].items()})} ms "
              f"({100 * res['comm_share_of_timed_step']:.1f}%); peak "
              f"{[round(g, 2) for g in res['peak_gib_per_rank']]} GiB per rank, world 1 "
              f"{res['world1_peak_gib']:.2f}; K1 {res['launches_per_rank']} launches per rank ({name})",
              flush=True)
    return result, launches


class SignalledTrainSet(MemoryTrainSet):
    """Sends SIGTERM to this process at its first decode of epoch 1."""

    sent = False

    def _decode(self, idx: int) -> np.ndarray:
        if self.epoch == 1 and not SignalledTrainSet.sent:
            SignalledTrainSet.sent = True
            os.kill(os.getpid(), signal.SIGTERM)
        return super()._decode(idx)


def stop_tree_sizes() -> list:
    return [TRAIN_TREE_SIZES[i % 3] for i in range(STOP_IMAGES)]


def worker_stop(store: str, rank: str, out_dir: str) -> None:
    out = Path(out_dir)
    ann = out / "wider_face_train_bbx_gt.txt"
    images = pink_images(np.random.default_rng(81), stop_tree_sizes())
    cls = SignalledTrainSet if rank == "1" else MemoryTrainSet
    dataset = cls(ann, images, load_templates(), DetectorConfig())
    args = train_cli.arguments([str(ann), str(ann), "--device", "cuda", "--epochs", "4",
                                "--save-every", "10", "--workers", "4", "--num-processes", "2",
                                "--process-id", rank, "--coordinator-address", store])
    assignment_kernel.launch_count = 0
    with contextlib.chdir(out):
        trainer = train_cli.run(args, dataset, backend="gloo")
    print(json.dumps({"rank": int(rank), "step": trainer.step,
                      "launches": assignment_kernel.launch_count}), flush=True)


def phase_agreed_stop(name: str) -> tuple[dict, int]:
    """Phase 20 (C): the training CLI's loop in two ranks on gloo on one
    card over a 12-image tree of phase 8's kind (one step per epoch); rank
    1 alone gets SIGTERM in epoch 1. Both ranks stop after epoch 1, both
    call the checkpoint save (rank 0 writes checkpoint_2), both pass the
    exit barrier, and neither hangs."""
    out = DIST_DIR / "stop"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    train_annotations(out, np.random.default_rng(82), stop_tree_sizes())
    outs = spawn_ranks("stop", [["stop", fresh_store("stop"), str(r), str(out)] for r in range(2)])
    done = [json.loads([line for line in o.splitlines() if line.startswith('{"rank"')][-1])
            for o in outs]
    check([d["step"] for d in done] == [2, 2] and [d["launches"] for d in done] == [2, 2],
          f"ranks stopped at steps {[d['step'] for d in done]} with K1 launches "
          f"{[d['launches'] for d in done]}, want 2 each (epochs 0 and 1)")
    check("will checkpoint and stop" in outs[1] and "will checkpoint and stop" not in outs[0],
          "only rank 1 was to be signalled")
    written = sorted(p.name for p in (out / "weights").iterdir())
    check(written == ["checkpoint_2"] and load_checkpoint(out / "weights" / "checkpoint_2")["epoch"] == 2,
          f"checkpoints {written}")
    print(f"agreed stop: SIGTERM to rank 1 in epoch 1, both ranks stopped after epoch 1 (step 2), "
          f"checkpoint_2 written by rank 0, both through the exit barrier ({name})", flush=True)
    return ({"stopped_at_step": [d["step"] for d in done], "checkpoints": written},
            sum(d["launches"] for d in done))


def worker_eval(store: str, rank: str, weights: str, out_dir: str) -> None:
    distributed.initialize(store, 2, int(rank), backend="gloo", device="cpu")
    model = TinyFacesDetector(dtype=torch.bfloat16)
    model.load_state_dict(torch.load(weights, weights_only=True))
    det = PyramidDetector(model, load_templates(), DetectorConfig(), EvalConfig(), device="cuda")
    evaluate_model.run(det, MemoryDataset(sweep_items(np.random.default_rng(7))), 0.03, 0.3, "val",
                       results_dir=out_dir, eval_batch=32, workers=4, rank=int(rank), world=2)
    distributed.barrier_at_exit("eval_sweep_done")


def result_tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*.txt")}


def phase_eval_distributed(calibrated: TinyFacesDetector, templates_np, dev: torch.device,
                           name: str) -> dict:
    """Phase 21 (D): phase 7's sweep (a) data-parallel over every card
    (`device=local_devices("cuda")`, one replica each) against the
    single-card sweep whose batches are the same pieces (phase 7's tree on
    one card, eval batch 32 / cards otherwise), then a warm batch of 32
    timed on every card and on one; and (b) by two processes of a gloo
    group (`--coordinator-address` with `--num-processes 2`), each writing
    its images r::2: disjoint halves whose union is phase 7's tree. Byte
    for byte."""
    items = sweep_items(np.random.default_rng(7))
    cards = local_devices("cuda")
    reference = SWEEP_DIR
    if len(cards) > 1:
        reference = DIST_DIR / "single_piece"
        shutil.rmtree(reference, ignore_errors=True)
        det = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                              device=dev)
        evaluate_model.run(det, MemoryDataset(items), 0.03, 0.3, "val", results_dir=reference,
                           eval_batch=32 // len(cards), workers=4)
    dp_dir = DIST_DIR / "data_parallel"
    shutil.rmtree(dp_dir, ignore_errors=True)
    det = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                          device=cards)
    evaluate_model.run(det, MemoryDataset(items), 0.03, 0.3, "val", results_dir=dp_dir,
                       eval_batch=32, workers=4)
    want = result_tree(reference)
    check(len(want) == len(items) and result_tree(dp_dir) == want,
          f"the data-parallel sweep over {len(cards)} cards differs from the single-card tree")
    batch = pink_images(np.random.default_rng(9), [(480, 360)] * 32)
    rates = {len(cards): warm_batch_rate(det, batch)}
    del det
    if len(cards) > 1:
        one = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                              device=dev)
        rates[1] = warm_batch_rate(one, batch)
        del one
    torch.cuda.empty_cache()

    weights = DIST_DIR / "calibrated.pt"
    torch.save(calibrated.state_dict(), weights)
    halves = [DIST_DIR / f"eval_rank{r}" for r in range(2)]
    for h in halves:
        shutil.rmtree(h, ignore_errors=True)
    store = fresh_store("eval")
    spawn_ranks("eval", [["eval", store, str(r), str(weights), str(halves[r])] for r in range(2)])
    got = [result_tree(h) for h in halves]
    check(not set(got[0]) & set(got[1]) and len(got[0]) == len(got[1]) == len(items) // 2
          and {**got[0], **got[1]} == result_tree(SWEEP_DIR),
          f"the two ranks wrote {len(got[0])} and {len(got[1])} files "
          f"({len(set(got[0]) & set(got[1]))} in both); their union differs from phase 7's tree")
    print(f"distributed sweep: data-parallel over {len(cards)} card(s) byte-equal to the single-card "
          f"tree; a warm batch of 32 480x360 images (bf16) at "
          f"{', '.join(f'{v:.2f} img/s on {k} card(s)' for k, v in sorted(rates.items()))}; two "
          f"coordinated ranks wrote disjoint halves ({len(got[0])} + {len(got[1])} files) whose "
          f"union is phase 7's tree ({name})", flush=True)
    return {"data_parallel_cards": len(cards),
            "warm_batch32_img_per_s_by_cards": {str(k): v for k, v in rates.items()},
            "coordinated_files": [len(g) for g in got]}


def warm_batch_rate(det: PyramidDetector, images: list, runs: int = 3) -> float:
    """img/s of det.detect_batch(images), median of `runs` after one
    warm-up call (cuDNN's set-up on every card)."""
    det.detect_batch(images, 0.03)
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        det.detect_batch(images, 0.03)
        times.append(time.perf_counter() - t0)
    return len(images) / float(np.median(times))


# --- one image over several cards, K steps from one graph, tools: 26-28 ---

SLICE10_DIR = ROOT / "build" / "chip_smoke" / "slice10"


def spatial_devices() -> list[torch.device]:
    """Every card; on one card, that card four times (the same halo code
    with same-device copies)."""
    cards = local_devices("cuda")
    return cards if len(cards) > 1 else cards * 4


def peak_by_card(devices) -> dict:
    return {str(d): torch.cuda.max_memory_allocated(d) / 2**30 for d in sorted(set(devices), key=str)}


def reset_peaks(devices) -> None:
    for d in set(devices):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)


def same_detections(got: np.ndarray, want: np.ndarray, rtol: float = 1e-4, atol: float = 1e-3) -> bool:
    """The same count, and the rows pair one to one within np.allclose's
    tolerance (NMS may list two near-equal scores in either order)."""
    if got.shape != want.shape:
        return False
    used = np.zeros(len(got), bool)
    for w in want:
        ok = ~used & (np.abs(got - w) <= atol + rtol * np.abs(w)).all(1)
        if not ok.any():
            return False
        used[int(np.argmax(ok))] = True
    return True


def iou_matched_share(got: np.ndarray, want: np.ndarray, min_iou: float = 0.99):
    """Greedy one-to-one pairing of want's rows with got's by IoU: the share
    of want's rows paired at IoU >= min_iou, and the largest score
    difference of a pair."""
    if not len(want):
        return float(len(got) == 0), 0.0
    iou = iou_np(want[:, :4], got[:, :4]) if len(got) else np.zeros((len(want), 0))
    used = np.zeros(len(got), bool)
    hits, score_diff = 0, 0.0
    for j in range(len(want)):
        cand = np.where(~used, iou[j], -1.0)
        if cand.size and cand.max() >= min_iou:
            i = int(np.argmax(cand))
            used[i] = True
            hits += 1
            score_diff = max(score_diff, float(abs(got[i, 4] - want[j, 4])))
    return hits / len(want), score_diff


def rms(t: torch.Tensor) -> float:
    return float(t.double().pow(2).mean().sqrt())


def phase_spatial(calibrated: TinyFacesDetector, templates_np, dev: torch.device, name: str) -> dict:
    """Phase 26: one image's forward split over the cards by rows
    (parallel/spatial.py, shard="spatial") against the unsharded pyramid,
    EvalConfig() defaults, the 768x1024 bucket at batch 1 and 4, fp32 (TF32
    off) and bf16; then data_parallel_graphs over the same devices; then
    the evaluate_model CLI with --data-parallel --shard auto and spatial on
    5 JPEG files of phase 13's tree.

    fp32: the same detections (same_detections), or only near-ties
    unpaired at the same tolerance. bf16: the share of detections matched
    at IoU >= 0.99 and the largest score difference are printed beside the
    same share between two unsharded runs that differ only in batch size
    (batch 1 against the image's row of batch 4: cuDNN picks other
    algorithms, as it does for a slice), and the gate is the forward: the
    1x level's output in bf16, split and unsplit, against the fp32
    forward, the split's RMS error at most 1.5x the unsplit's (the split
    adds nothing beyond bf16's own rounding)."""
    devices = spatial_devices()
    n_cards = len(set(devices))
    images = pink_images(np.random.default_rng(26), [(768, 1024)] * 4)
    out = {"card": name, "devices": [str(d) for d in devices], "cards": n_cards,
           "measures": "correctness only (one card, repeated)" if n_cards == 1 else "speed"}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        model = TinyFacesDetector(dtype=dtype).to(dev)
        model.load_state_dict(calibrated.state_dict())
        base = PyramidDetector(model, templates_np, DetectorConfig(), EvalConfig(), device=dev)
        sp = PyramidDetector(model, templates_np, DetectorConfig(), EvalConfig(), device=devices,
                             shard="spatial")
        first_image = {}
        for b in (1, 4):
            r: dict = {}
            for tag, det in (("unsharded", base), ("spatial", sp)):
                packed = det.pack_inputs(images[:b])
                det._fetch(det.detect_batch_async(packed))  # cuDNN's first calls
                reset_peaks(det.devices)
                t0 = time.perf_counter()
                for _ in range(3):
                    dets = det._fetch(det.detect_batch_async(packed))
                r[tag] = {"ms_per_image": 1000.0 * (time.perf_counter() - t0) / (3 * b),
                          "peak_gib_by_card": peak_by_card(det.devices)}
                r[tag + "_dets"] = dets
            got, want = r.pop("spatial_dets"), r.pop("unsharded_dets")
            first_image[b] = want[0]
            n_want = sum(len(w) for w in want)
            r["counts"] = {"spatial": [len(g) for g in got], "unsharded": [len(w) for w in want]}
            check(all(g.ndim == 2 and g.shape[1] == 5 and np.isfinite(g).all() for g in got)
                  and n_want > 0, f"spatial {label} b{b}: outputs {[g.shape for g in got]}")
            if dtype is None:
                r["same_detections"] = all(same_detections(g, w) for g, w in zip(got, want))
                if not r["same_detections"]:  # only near-ties may differ, at the same tolerance
                    pairs = [match_detections(g, w, box_tol=1e-3 + 1e-4 * 2048,
                                              score_tol=1e-3 + 1e-4 * float(np.abs(w[:, 4]).max()))
                             for g, w in zip(got, want)]
                    r["unpaired_near_ties"] = sum(p[1] for p in pairs)
                verdict = (f"same count and rows within rtol 1e-4 / atol 1e-3: "
                           f"{r['same_detections']}, unpaired near-ties "
                           f"{r.get('unpaired_near_ties', 0)}")
            else:
                shares = [iou_matched_share(g, w) for g, w in zip(got, want)]
                r["matched_share_iou_0.99"] = sum(s * len(w) for (s, _), w in zip(shares, want)) / n_want
                r["max_score_diff"] = max(d for _, d in shares)
                x = normalize_images(torch.from_numpy(np.stack(images[:b])).to(dev), dtype=dtype)
                with torch.no_grad():
                    ref = calibrated(x.float())
                    err_un = rms(model(x) - ref) / rms(ref)
                    err_sp = rms(spatial_forward([rep.model for rep in sp.replicas],
                                                 x.permute(0, 3, 1, 2).contiguous()) - ref) / rms(ref)
                r["forward_rms_err_vs_fp32"] = {"spatial": err_sp, "unsharded": err_un}
                check(err_sp <= 1.5 * err_un, f"spatial bf16 b{b}: the split's forward error "
                      f"{err_sp:.3g} against the fp32 forward exceeds 1.5x the unsplit's {err_un:.3g}")
                verdict = (f"{100 * r['matched_share_iou_0.99']:.2f}% matched at IoU >= 0.99, max "
                           f"score diff {r['max_score_diff']:.3g}; 1x forward RMS error against fp32 "
                           f"{err_sp:.3g} split, {err_un:.3g} unsplit")
            r["detections"] = n_want
            out[f"{label}_b{b}"] = r
            print(f"spatial {label} batch {b} over {len(devices)} slices on {n_cards} card(s) "
                  f"({out['measures']}): {n_want} detections, counts {json.dumps(r['counts'])}, "
                  f"{verdict}; ms/image spatial {r['spatial']['ms_per_image']:.1f} vs unsharded "
                  f"{r['unsharded']['ms_per_image']:.1f}, peak GiB by card spatial "
                  f"{json.dumps({k: round(v, 2) for k, v in r['spatial']['peak_gib_by_card'].items()})}"
                  f" vs unsharded {r['unsharded']['peak_gib_by_card'][str(dev)]:.2f} ({name})",
                  flush=True)
        share, diff = iou_matched_share(first_image[4], first_image[1])
        out[f"{label}_batch_size_control"] = {"matched_share_iou_0.99": share, "max_score_diff": diff}
        print(f"  control, {label} unsharded: image 0 at batch 4 against batch 1: {100 * share:.2f}% "
              f"matched at IoU >= 0.99, max score diff {diff:.3g}", flush=True)
        del model, base, sp
        gc.collect()
        torch.cuda.empty_cache()
    out["data_parallel_graphs"] = data_parallel_graphs(calibrated, templates_np, devices, name)
    out["cli"] = spatial_cli(calibrated, devices)
    return out


def data_parallel_graphs(calibrated: TinyFacesDetector, templates_np, devices: list, name: str) -> dict:
    """Phase 26 (end): shard="batch" over the same devices, one replica and
    one 768x1024 image each, fp32: three calls (the first eager, the second
    captures every replica's graph on its own stream into its own pool, the
    third replays), each replayed output bit-equal to the eager path's
    (trace set); every replica holds one graph and its pool's memory lies
    on its own card."""
    images = pink_images(np.random.default_rng(261), [(768, 1024)] * len(devices))
    det = PyramidDetector(copy.deepcopy(calibrated), templates_np, DetectorConfig(), EvalConfig(),
                          device=devices)
    packed = det.pack_inputs(images)
    outs = [result_of(det, packed) for _ in range(3)]
    with eager(det):
        plain = result_of(det, packed)
    stats = det.graph_stats()
    segs = torch.cuda.memory_snapshot()
    pool_cards = [sorted({s["device"] for s in segs
                          if tuple(s.get("segment_pool_id", ())) == tuple(r.cache.pool.id)})
                  for r in det.replicas]
    same = [bool(np.array_equal(o.view(np.uint32), plain.view(np.uint32))) for o in outs]
    r = {"replicas": len(devices), "bit_equal_by_call": same, "graphs": [s["graphs"] for s in stats],
         "pool_cards": pool_cards, "pool_gib": [s["pool_reserved_bytes"] / 2**30 for s in stats],
         "capture_s": [s["capture_s"] for s in stats]}
    check(all(same) and r["graphs"] == [1] * len(devices)
          and pool_cards == [[d.index] for d in devices],
          f"data-parallel graphs over {devices}: {r}")
    print(f"data-parallel fp32 over {len(devices)} replicas ({len(set(devices))} card(s)), one image "
          f"each: eager, capture and replay bit-equal to the eager path {same}, one graph per "
          f"replica, pools on cards {pool_cards}, {[round(g, 2) for g in r['pool_gib']]} GiB ({name})",
          flush=True)
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return r


def spatial_cli(calibrated: TinyFacesDetector, devices: list) -> dict:
    """evaluate_model.main --fp32 --debug (5 images) on phase 13's JPEG
    tree: unsharded, --data-parallel --shard auto (every card) and
    --data-parallel --shard spatial over the spatial devices; the result
    files of both sharded runs pair with the unsharded run's."""
    tree = ROOT / "build" / "chip_smoke" / "val_jpeg"
    weights = SLICE10_DIR / "calibrated"
    weights.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"model": calibrated.state_dict()}, weights)
    common = [str(tree / "wider_face_val_bbx_gt.txt"), "--dataset-root", str(tree), "--checkpoint",
              str(weights), "--fp32", "--debug", "--eval-batch", "4", "--workers", "4"]
    runs = {"unsharded": [], "auto": ["--data-parallel", "--shard", "auto"],
            "spatial": ["--data-parallel", "--shard", "spatial"]}
    trees = {}
    real_local_devices = evaluate_model.local_devices
    try:
        for tag, extra in runs.items():
            if tag == "spatial":
                evaluate_model.local_devices = lambda device: list(devices)
            results = SLICE10_DIR / f"cli_{tag}"
            shutil.rmtree(results, ignore_errors=True)
            evaluate_model.main(common + extra + ["--results_dir", str(results)])
            files, n_dets = check_result_tree(results, 5)
            trees[tag] = {f.relative_to(results): np.array(
                [ln.split() for ln in f.read_text().splitlines()[2:]], float).reshape(-1, 5)
                for f in files}
    finally:
        evaluate_model.local_devices = real_local_devices
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    out = {}
    for tag in ("auto", "spatial"):
        check(trees[tag].keys() == trees["unsharded"].keys(), f"cli {tag}: other result files")
        pairs = unpaired = 0
        for key, want in trees["unsharded"].items():
            # integer boxes: a sub-pixel difference may flip a rounding
            p, u, _, _ = match_detections(trees[tag][key], want, box_tol=1.0, score_tol=1e-3)
            pairs, unpaired = pairs + p, unpaired + u
        out[tag] = {"pairs": pairs, "unpaired_near_ties": unpaired}
    print(f"evaluate_model --fp32 --debug (5 JPEG files): --shard auto and --shard spatial "
          f"({len(devices)} slices) against the unsharded run: {json.dumps(out)}", flush=True)
    return out


def state_of(model: TinyFacesDetector, opt: torch.optim.Optimizer) -> list:
    momentum = [opt.state[p]["momentum_buffer"] for g in opt.param_groups for p in g["params"]]
    return [*model.state_dict().values(), *momentum]


def phase_multi(templates_np, dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 27: make_multi_train_step (one captured CUDA graph of the step)
    at K=4, batch 12, 500x500, fp32, deterministic cuDNN, twice (a warm-up
    step, the capture and 3 replays; then 2 replays, a capture at the
    schedule's next rate and 2 replays of it), then at batch 8 (a warm-up
    step at the new shape, the capture, 2 replays), against 12 plain
    steps from the same state and the same draws: losses, parameters, BN
    statistics and momentum bit-equal (or within rtol 1e-6, printed); K1
    once a step. Then tools.train_bench --multi 4 and its plain step.
    Returns the numbers and K1's launches on the multi path."""
    from tinyfaces_tpu_torch.bench_train import make_synthetic_train_batch
    from tinyfaces_tpu_torch.trainer import make_multi_train_step, step_generator, train_step

    cfg, k = DetectorConfig(), 4
    # the staircase steps down after step 5: the second call recaptures for
    # the new rate at step 6
    tc = TrainConfig(batch_size=12, lr_step_epochs=1)
    rng = np.random.default_rng(27)
    rows = [tc.batch_size] * 2 * k + [8] * k  # the third call at a second batch shape
    host = [make_synthetic_train_batch(rng, r, cfg) for r in rows]
    batches = [{n: torch.from_numpy(v).to(dev) for n, v in b.items()} for b in host]
    trainers = []
    for _ in range(2):
        model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0))
        trainers.append(Trainer(model=model, cfg=cfg, tc=tc, templates=templates_np, device=dev, seed=3))
        trainers[-1].setup(steps_per_epoch=6)
    multi_t, plain_t = trainers
    check(multi_t.schedule(5) != multi_t.schedule(6), "the rate does not step down at step 6")
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out: dict = {"card": name, "k": k}
    try:
        multi = make_multi_train_step(multi_t.model, multi_t.opt, cfg, multi_t.templates_t,
                                      multi_t.schedule)
        assignment_kernel.launch_count = 0
        t0 = time.perf_counter()
        got, out["call_s"] = [], []
        for c in range(3):  # the first and the third warm up a batch shape: cuDNN's search
            t1 = time.perf_counter()
            stacked = {n: torch.stack([b[n] for b in batches[c * k:(c + 1) * k]]) for n in batches[0]}
            got.append(torch.stack(list(multi(stacked, multi_t.seed, c * k))))
            torch.cuda.synchronize(dev)
            out["call_s"].append(time.perf_counter() - t1)
        out["multi_s"] = time.perf_counter() - t0
        launches = assignment_kernel.launch_count
        check(launches == 3 * k, f"multi: K1 {launches} launches in {3 * k} steps")
        want = []
        for step, b in enumerate(batches):
            lb = train_step(plain_t.model, plain_t.opt, b, step_generator(plain_t.seed, step, dev),
                            cfg=cfg, templates=plain_t.templates_t, lr=plain_t.schedule(step))
            want.append(torch.stack(list(lb)))
        got, want = torch.cat(got, 1).t(), torch.stack(want)
        pairs = list(zip(state_of(multi_t.model, multi_t.opt), state_of(plain_t.model, plain_t.opt)))
        out["losses_bit_equal"] = bool(torch.equal(got, want))
        out["state_bit_equal"] = all(torch.equal(a, b) for a, b in pairs)
        rel = lambda a, b: float((a.double() - b.double()).abs().max() / max(float(b.double().abs().max()), 1e-30))  # noqa: E731
        out["losses_max_rel_diff"] = rel(got, want)
        out["state_max_rel_diff"] = max(rel(a, b) for a, b in pairs if a.is_floating_point())
        check(torch.isfinite(got).all() and out["losses_max_rel_diff"] <= 1e-6
              and out["state_max_rel_diff"] <= 1e-6,
              f"multi step against plain steps: losses {got.tolist()} vs {want.tolist()}, state "
              f"max rel diff {out['state_max_rel_diff']:.3g}")
        del multi
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"multi step K={k} (CUDA graph) against {3 * k} plain steps, ResNet-101 batch 12 then 8, "
          f"fp32, deterministic cuDNN, timed engine search: losses bit-equal {out['losses_bit_equal']} "
          f"(max rel "
          f"{out['losses_max_rel_diff']:.3g}), parameters/BN/momentum bit-equal "
          f"{out['state_bit_equal']} (max rel {out['state_max_rel_diff']:.3g}), K1 {launches} "
          f"launches, the calls {[round(x, 2) for x in out['call_s']]} s ({name})", flush=True)
    del trainers, multi_t, plain_t, batches
    gc.collect()
    torch.cuda.empty_cache()
    INSTRUMENTS_DIR.mkdir(parents=True, exist_ok=True)
    bench = run_tool("train_bench_multi", train_bench.main, ["--multi", str(k), "--iters", "3"])
    m = bench["multi"]
    check(m["k1_launches"] == (m["iters"] + 1) * k and np.isfinite(m["losses"]).all()
          and bench["k1_launches"] == bench["iters"] + bench["warmup_steps"],
          f"train_bench --multi: K1 {m['k1_launches']} and {bench['k1_launches']} launches")
    out["train_bench"] = {"multi_ms_per_step": m["ms_per_step"], "plain_ms_per_step": bench["ms_per_step"],
                          "multi_img_per_s": m["img_per_s"], "plain_img_per_s": bench["img_per_s"],
                          "multi_peak_gib": m["peak_gib"], "plain_peak_gib": bench["peak_gib"]}
    print(f"train_bench --multi {k}: {m['ms_per_step']:.2f} ms/step against the plain step's "
          f"{bench['ms_per_step']:.2f} in the same process ({name})", flush=True)
    return out, launches + m["k1_launches"]


def phase_trainer_capture(templates_np, dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 30: Trainer.train_step's captured route against eager steps,
    the step timed both ways with a loss read after each, and a profiled
    CLI epoch (see the module docstring). Returns the numbers and K1's
    launches in the compared and the CLI's steps."""
    from perfbench import tracefile
    from tinyfaces_tpu_torch.bench_train import make_synthetic_train_batch
    from tinyfaces_tpu_torch.trainer import step_generator, train_step

    cfg, tc = DetectorConfig(), TrainConfig(batch_size=12)
    rows = [tc.batch_size] * 6 + [8] * 2  # a second batch shape after the first capture
    n = len(rows)
    rng = np.random.default_rng(30)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in make_synthetic_train_batch(
        rng, r, cfg).items()} for r in rows]
    trainers = []
    for _ in range(2):
        model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0))
        trainers.append(Trainer(model=model, cfg=cfg, tc=tc, templates=templates_np, device=dev, seed=3))
        trainers[-1].setup(steps_per_epoch=100)
    graphed_t, plain_t = trainers
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    out: dict = {"card": name, "steps": n}
    stop = threading.Event()

    def producer():
        """What the loader's producer does beside the steps: pin a batch's
        host memory, copy it on a stream of its own, drop it (so the host
        allocator queries the copy's event before it reuses the block)."""
        side = torch.cuda.Stream(dev)
        while not stop.is_set():
            host = torch.empty(tc.batch_size * 500 * 500 * 3, dtype=torch.uint8).pin_memory()
            with torch.cuda.stream(side):
                host.to(dev, non_blocking=True)
            time.sleep(0.001)

    pinner = threading.Thread(target=producer, name="phase 30 producer", daemon=True)
    pinner.start()
    try:
        launches0 = assignment_kernel.launch_count
        kept = [graphed_t.train_step(b) for b in batches]  # each read only after the last step
        stop.set()
        pinner.join(timeout=60)
        check(not pinner.is_alive(), "phase 30's producer thread did not stop")
        got = torch.stack([torch.stack(list(lb)) for lb in kept])
        launches = assignment_kernel.launch_count - launches0
        want = torch.stack([torch.stack(list(train_step(
            plain_t.model, plain_t.opt, b, step_generator(plain_t.seed, i, dev), cfg=cfg,
            templates=plain_t.templates_t, lr=plain_t.schedule(i)))) for i, b in enumerate(batches)])
        plain_t.step = n
        pairs = list(zip(state_of(graphed_t.model, graphed_t.opt), state_of(plain_t.model, plain_t.opt)))
        rel = lambda a, b: float((a.double() - b.double()).abs().max() / max(float(b.double().abs().max()), 1e-30))  # noqa: E731
        out.update(step_counts=dict(graphed_t.step_counts), tuned_s=graphed_t.tuned_s, k1_launches=launches,
                   losses_bit_equal=bool(torch.equal(got, want)),
                   state_bit_equal=all(torch.equal(a, b) for a, b in pairs),
                   losses_max_rel_diff=rel(got, want),
                   state_max_rel_diff=max(rel(a, b) for a, b in pairs if a.is_floating_point()))
        check(graphed_t.step_counts == {"eager": 2, "captured": 2, "replayed": n - 2, "tuned": 2},
              f"the captured route's steps: {graphed_t.step_counts}")
        check(launches == n, f"the captured route: K1 {launches} launches in {n} steps")
        check(torch.isfinite(got).all() and out["losses_max_rel_diff"] <= 1e-6
              and out["state_max_rel_diff"] <= 1e-6,
              f"the captured route against eager steps: losses {got.tolist()} vs {want.tolist()}, "
              f"state max rel diff {out['state_max_rel_diff']:.3g}")
    finally:
        stop.set()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    print(f"Trainer.train_step, captured route, {n} steps (batch 12: warm-up, capture, 5 replays; batch 8: "
          f"warm-up, capture, replay; a thread pinning and copying host memory throughout) against "
          f"{n} eager steps, ResNet-101 fp32, deterministic cuDNN, timed engine search: losses bit-equal "
          f"{out['losses_bit_equal']} (max rel {out['losses_max_rel_diff']:.3g}), parameters/BN/momentum "
          f"bit-equal {out['state_bit_equal']} (max rel {out['state_max_rel_diff']:.3g}), step_counts "
          f"{out['step_counts']}, the tuned steps {out['tuned_s']:.2f} s, K1 {launches} launches ({name})",
          flush=True)

    # The step with its loss read after it, eager (plain_t) and replayed
    # (graphed_t, recaptured once for default cuDNN) in turns.
    graphed_t.setup(steps_per_epoch=100)

    def timed(t, eager: bool, steps: int = 5) -> float:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for b in batches[:steps]:
            if eager:
                lb = train_step(t.model, t.opt, b, t.step_generator(), cfg=cfg, templates=t.templates_t,
                                lr=t.schedule(t.step))
                t.step += 1
            else:
                lb = t.train_step(b)
            float(lb.total)
        return 1e3 * (time.perf_counter() - t0) / steps

    timed(plain_t, True, 2)
    timed(graphed_t, False, 2)  # its warm-up step, then the capture
    turns = [("eager", timed(plain_t, True)), ("replay", timed(graphed_t, False)),
             ("replay", timed(graphed_t, False)), ("eager", timed(plain_t, True))]
    out["step_ms"] = {k: [ms for kind, ms in turns if kind == k] for k in ("eager", "replay")}
    # the comparison's n - 2 replays, the capture's after setup() and the 10 timed
    check(graphed_t.step_counts["replayed"] == n - 2 + 1 + 10, f"timed steps: {graphed_t.step_counts}")
    print(f"the step with a loss read after each, default cuDNN, in turns: eager {out['step_ms']['eager']} "
          f"ms, replayed {out['step_ms']['replay']} ms ({name})", flush=True)
    del trainers, graphed_t, plain_t, batches, kept
    gc.collect()
    torch.cuda.empty_cache()

    # One profiled CLI epoch on the phase's own tree: the capture runs
    # under the profiler, the replays' kernels reach its trace.
    root = ROOT / "build" / "chip_smoke" / "capture"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    ann, images = write_train_tree(root, np.random.default_rng(30))
    dataset = MemoryTrainSet(ann, images, templates_np, cfg)
    launches0 = assignment_kernel.launch_count
    trainer = run_train_cli(ann, dataset, dev, root / "run", "--epochs", "1",
                            "--profile-dir", str(root / "profile"))
    cli_launches = assignment_kernel.launch_count - launches0
    steps = trainer.step
    counts = dict(trainer.step_counts)
    del trainer
    trace = json.loads((root / "profile" / "trace.json").read_text())
    k1 = sum(1 for e in trace["traceEvents"] if e.get("cat") == "kernel"
             and tracefile.kernel_is(e.get("name", ""), ("reduce_kernel",)))
    spans = json.loads((root / "profile" / "spans.json").read_text())["spans"]
    paths = [s["attrs"]["path"] for s in spans if s["name"] == "train.step"]
    out["profiled_epoch"] = {"steps": steps, "step_counts": counts, "k1_in_trace": k1,
                             "paths": paths, "trace_mib": (root / "profile" / "trace.json").stat().st_size / 2**20}
    check(counts == {"eager": 1, "captured": 1, "replayed": steps - 1, "tuned": 1} and cli_launches == steps,
          f"profiled epoch: {counts}, K1 {cli_launches} launches in {steps} steps")
    check(paths == ["eager", "capture"] + ["replay"] * (steps - 2), f"profiled epoch's paths {paths}")
    if k1 != steps:  # which steps' K1 the trace lacks: its kernels' and the steps' times
        t_k1 = sorted(e["ts"] for e in trace["traceEvents"] if e.get("cat") == "kernel"
                      and tracefile.kernel_is(e.get("name", ""), ("reduce_kernel",)))
        t_steps = sorted((e["ts"], e.get("dur")) for e in trace["traceEvents"]
                         if e.get("name") == profiling.PREFIX + "train.step")
        kinds = collections.Counter(e.get("cat") for e in trace["traceEvents"])
        print(f"profiled epoch: K1 at {t_k1}, train.step spans at {t_steps}, events {dict(kinds)}",
              flush=True)
    check(k1 == steps, f"profiled epoch: K1's kernel {k1} times in the trace of {steps} steps")
    print(f"main.run --profile-dir, one epoch of {steps} steps: paths {paths}, K1's kernel {k1} times "
          f"in the trace ({out['profiled_epoch']['trace_mib']:.1f} MiB) ({name})", flush=True)
    return out, launches + cli_launches


def phase_tools(name: str) -> dict:
    """Phase 28: tools.h2d_probe, tools.prewarm_cache and
    tools.kernel_selftest at small sizes."""
    from tinyfaces_tpu_torch.tools import h2d_probe, kernel_selftest, prewarm_cache

    INSTRUMENTS_DIR.mkdir(parents=True, exist_ok=True)
    probe = run_tool("h2d_probe", h2d_probe.main, ["--mib", "16", "--iters", "3"])
    check(all(r["mib_per_s"] > 0 for r in probe["rows"]), "h2d_probe: a rate is not positive")
    warm = run_tool("prewarm_cache", prewarm_cache.main, [])
    check({r["name"] for r in warm["libraries"]} == {"dense_assignment", "nms", "tinyfaces_native", "jpeg_dct"},
          f"prewarm_cache: {warm}")
    selftest = run_tool("kernel_selftest", kernel_selftest.main, ["--iters", "5"])
    check(selftest["ok"], f"kernel_selftest: {selftest}")
    print(f"tools: h2d_probe {len(probe['rows'])} rows, pinned noise "
          f"{probe['rows'][0]['mib_per_s']:.0f} MiB/s; prewarm_cache "
          f"{[(r['name'], r['compiled']) for r in warm['libraries']]}; kernel_selftest PASS, "
          f"mismatch {selftest['label_mismatch_rate']:.2e}, kernel {selftest['kernel_ms']:.3f} ms "
          f"vs plain {selftest['plain_ms']:.3f} ms ({name})", flush=True)
    return {"h2d_probe": probe["rows"], "prewarm_cache": warm, "kernel_selftest": selftest}


# --- the compiled pyramid and kernel N1: phase 29 ---------------------------

GRAPH_DIR = ROOT / "build" / "chip_smoke" / "graphs"
WIRE_SETTINGS = (("rgb", "linear"), ("jpegdct", "linear"), ("jpegdct4", "linear"),
                 ("yuv420", "linear"), ("rgb", "pil"))


def clustered_scene(rng, n: int, n_valid: int, equal: bool = False) -> tuple:
    """An NMS scene of n candidates: (boxes (n, 4) f32, scores (n,) f32,
    valid (n,) bool). Clusters of n // 60 boxes on a 0.5 px grid, one in 16
    of zero width or height; scores on a 1/8 grid or all equal; n_valid
    valid rows at random places."""
    k = max(2, n // 60)
    c = rng.uniform(50, 950, (k, 2))[rng.integers(0, k, n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    zero = rng.uniform(size=n) < 1 / 16
    wh[zero, rng.integers(0, 2, int(zero.sum()))] = 0.0
    b = (np.round(np.concatenate([c - wh / 2, c + wh / 2], 1) * 2) / 2).astype(np.float32)
    s = (np.full(n, 0.5) if equal else rng.integers(0, 40, n) / 8.0 - 2.0).astype(np.float32)
    v = np.zeros(n, bool)
    v[rng.permutation(n)[:n_valid]] = True
    return b, s, v


def n1_scenes(rng, n: int = 4000) -> list:
    """Phase 29's synthetic NMS scenes of n candidates: (label, boxes (n, 4)
    f32, scores (n,) f32, valid (n,) bool). Clustered scenes with valid
    counts 0, 1, 63, 64, 65 and n; all scores equal; and a chain of 200
    boxes 3 px apart (IoU 7/13 with the next, 1/4 with the one after),
    ranked in order, so that each kept box's suppression frees the box
    after next."""
    scenes = [(f"valid {k}", *clustered_scene(rng, n, k)) for k in (0, 1, 63, 64, 65, n)]
    scenes.append(("equal scores", *clustered_scene(rng, n, n, equal=True)))
    b, s, v = clustered_scene(rng, n, n)
    x = 3.0 * np.arange(200, dtype=np.float32)
    b[:200] = np.stack([x, np.zeros_like(x), x + 10, np.full_like(x, 10)], 1) + 2000.0
    s[:200] = 10.0 - np.arange(200, dtype=np.float32) / 256
    v[:200] = True
    scenes.append(("chain of 200", b, s, v))
    return scenes


def rank_for_nms(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor):
    """The rank-sorted (boxes, valid) that nms() hands its keep step."""
    ranked = torch.where(valid, scores, -torch.inf)
    order = torch.sort(ranked, dim=1, descending=True, stable=True).indices
    n = order.shape[1]
    return boxes.gather(1, order[..., None].expand(-1, n, 4)), valid.gather(1, order)


def n1_against_plain(label: str, boxes_s: torch.Tensor, valid_s: torch.Tensor, thr: float) -> int:
    """N1's keep mask on the card equal, bit for bit, to nms_blocked_reference's
    and to the plain fixpoint's on the same inputs; returns the largest
    difference (0)."""
    got = nms_kernel._launch(boxes_s, valid_s, thr)
    ref = nms_kernel.nms_blocked_reference(boxes_s, valid_s, thr)
    fix = nms_ops._plain_keep(boxes_s, valid_s, thr)
    torch.cuda.synchronize()
    err = max(int((got.int() - ref.int()).abs().max()), int((got.int() - fix.int()).abs().max()))
    check(err == 0 and not bool((got & ~valid_s).any()),
          f"N1 {label} thr {thr}: {int((got != ref).sum())} rows differ from the blocked reference, "
          f"{int((got != fix).sum())} from the fixpoint")
    return err


def n1_edge_inputs(rng, dev: torch.device) -> dict:
    """Rank-sorted keep-step inputs beside the pyramid's and
    n1_timed_inputs': invalid rows interleaved below valid ones (each
    image's extent past its valid count); one valid box in 20 with a NaN
    coordinate; N = 33 and 4001, not multiples of 64; and N = 16,000 at
    B = 2, all valid, past the rows N1 stages in shared memory
    (nms_kernel.smem_rows), so the rest are read from device memory."""
    def batch(n, n_valid, b):
        return [torch.from_numpy(np.stack(x)).to(dev)
                for x in zip(*[clustered_scene(rng, n, n_valid) for _ in range(b)])]

    out = {}
    bx, vd = rank_for_nms(*batch(4000, 4000, 4))
    holes = torch.from_numpy(rng.uniform(size=tuple(vd.shape)) < 0.3).to(dev)
    holes[:, -1] = False  # the last row stays valid: extent N, about 0.7 N valid
    out["interleaved invalid B4"] = (bx, vd & ~holes)
    bx, vd = rank_for_nms(*batch(4000, 3000, 4))
    nan = torch.from_numpy(rng.uniform(size=tuple(vd.shape)) < 0.05).to(dev) & vd
    coord = torch.from_numpy(rng.integers(0, 4, tuple(vd.shape))).to(dev)
    bx = bx.clone()
    bx[nan, coord[nan]] = float("nan")
    out["NaN boxes B4"] = (bx, vd)
    for n in (33, 4001):
        out[f"N={n} B3"] = rank_for_nms(*batch(n, n - n // 10, 3))
    out["N=16000 B2"] = rank_for_nms(*batch(16000, 16000, 2))
    return out


class NmsRecorder:
    """Keeps a copy of the inputs of every batched_nms_padded call the
    pyramid makes while it is entered (the concatenated decode outputs)."""

    def __enter__(self):
        self.calls, self.orig = [], evaluation.batched_nms_padded

        def record(boxes, scores, thr, valid, max_out):
            self.calls.append((boxes.clone(), scores.clone(), valid.clone()))
            return self.orig(boxes, scores, thr, valid, max_out)

        evaluation.batched_nms_padded = record
        return self

    def __exit__(self, *exc):
        evaluation.batched_nms_padded = self.orig


def result_of(det: PyramidDetector, packed) -> np.ndarray:
    """The packed (B, K, 6) host output of one detect_batch_async call."""
    res = det.detect_batch_async(packed)
    for e in res.events:
        e.synchronize()
    return res.host.numpy().copy()


@contextlib.contextmanager
def eager(det: PyramidDetector):
    """The detector's eager path: a trace set (its events discarded)."""
    det.trace = []
    try:
        yield det
    finally:
        det.trace = None


@contextlib.contextmanager
def sync_errors():
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def detections_of(packed: np.ndarray) -> list:
    return [p[p[:, 5] > 0, :5] for p in packed]


def phase_n1(recorded: dict, dev: torch.device, name: str) -> dict:
    """Phase 29 (a): N1 against nms_blocked_reference and the plain fixpoint
    on the card, keep masks bit-equal, each at thresholds 0.3 and 0.5: the
    decode outputs phase 5's model gives the 768x1024 pyramid at batch 32
    and 1 (bf16 and fp32, recorded by (b)), the synthetic scenes in one
    batch, 32 scenes of 4000 rows all valid, and n1_edge_inputs. Then N1
    timed (CUDA events, median of 20: a call from the host, and the device
    time of a CUDA-graph replay) beside the plain keep step (median of 20)
    and the blocked reference (median of 3) on n1_timed_inputs (B = 32 and
    B = 1 of the bf16 decode outputs and of bench's, and the all-valid B =
    32), with
    nms_bound of those inputs and N1's keep mask (the pairs under a kept
    row)."""
    t0 = time.perf_counter()
    scenes = n1_scenes(np.random.default_rng(29))
    syn = [torch.from_numpy(np.stack(x)).to(dev) for x in list(zip(*scenes))[1:]]
    timed = n1_timed_inputs(recorded["bf16 b32"], dev)
    inputs = {f"synthetic B={len(scenes)}": rank_for_nms(*syn),
              **{label: rank_for_nms(*x) for label, x in recorded.items()},
              "all valid B32": timed["all valid B32"], **n1_edge_inputs(np.random.default_rng(32), dev)}
    geometry = {}
    for label, (bx, vd) in inputs.items():  # the library's launch against the hand-counted copies
        b, n = vd.shape
        g = geometry[label] = nms_kernel.launch_geometry(b, n, dev)
        check((g["cluster"], g["threads"]) == nms_kernel.launch_shape(b)
              and g["staged_rows"] == nms_kernel.smem_rows(n, optin=g["smem_optin"], threads=g["threads"]),
              f"N1 {label}: the library launches {g}, nms_kernel counts {nms_kernel.launch_shape(b)} and "
              f"{nms_kernel.smem_rows(n, optin=g['smem_optin'], threads=g['threads'])} staged rows")
    over = inputs["N=16000 B2"]
    staged = geometry["N=16000 B2"]["staged_rows"]
    check(int(nms_kernel.valid_extent(over[1]).min()) > staged,
          f"N=16000: the valid extent does not pass the {staged} rows staged in shared memory")
    err, checked = 0, []
    for thr in (0.3, 0.5):
        for label, (bx, vd) in inputs.items():
            err = max(err, n1_against_plain(label, bx, vd, thr))
            checked.append(f"{label} thr {thr}")
    timing = {}
    for label, (bx, vd) in timed.items():
        bx, vd = bx.contiguous(), vd.contiguous()
        ext = nms_kernel.valid_extent(vd)
        bound = nms_kernel.nms_bound(vd, nms_kernel._launch(bx, vd, 0.3))
        timing[label] = r = {
            "ms": cuda_ms(lambda: nms_kernel._launch(bx, vd, 0.3)),
            "device_ms": graph_ms(lambda: nms_kernel._launch(bx, vd, 0.3)),
            "plain_ms": cuda_ms(lambda: nms_ops._plain_keep(bx, vd, 0.3)),
            "blocked_reference_ms": cuda_ms(lambda: nms_kernel.nms_blocked_reference(bx, vd, 0.3),
                                            runs=3, warmup=1),
            "n": bx.shape[1], "valid_extent_max": int(ext.max()), "valid_extent_mean": float(ext.float().mean()),
            **bound}
        print(f"N1 {label}, N={r['n']} (valid extent mean {r['valid_extent_mean']:.0f}, max "
              f"{r['valid_extent_max']}): {r['ms']:.4f} ms a call, {r['device_ms']:.4f} ms on the device "
              f"(graph replay), plain keep step {r['plain_ms']:.3f} ms, blocked reference "
              f"{r['blocked_reference_ms']:.1f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
              f"{r['needed_pairs']} tests for {r['kept']} kept rows, of {r['valid_pairs']} valid pairs; "
              f"operations {r['operations_ms']:.4f}, bytes {r['bytes_ms']:.5f}, resolve chain "
              f"{r['serial_chain_ms']:.4f}) ({name})", flush=True)
    print(f"N1 keep masks bit-equal to the blocked reference and the fixpoint on {len(checked)} inputs "
          f"(N=16000: rows past {staged} read from device memory; launch geometry as counted: "
          f"{json.dumps(geometry)}): {checked} ({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"max_abs_err": err, "checked": checked, "smem_rows_16000": staged, "geometry": geometry, **timing}


def phase_graphs(calibrated: TinyFacesDetector, templates_np, fixtures: dict, dev: torch.device,
                 name: str) -> tuple[dict, dict]:
    """Phase 29 (b, c): per wire and resample setting (rgb, jpegdct,
    jpegdct4, yuv420, rgb with pil), fp32 (TF32 off) and bf16, EvalConfig()
    defaults, the 768x1024 bucket at batch 1 and 32: the first call (warm-up
    and capture), then the replayed graph's packed output against the eager
    path's on the same inputs: bit-equal in fp32, in bf16 reported (the
    share of equal values and of detections matched at IoU >= 0.99). At
    batch 1, one replay and one eager call under
    torch.cuda.set_sync_debug_mode("error"). The capture seconds and the
    pool's bytes per key; the eager runs share the graphs' pool, as every
    eager run on a GPU replica does. Returns the results and the NMS inputs
    recorded at rgb batch 32 for (a)."""
    pink = pink_images(np.random.default_rng(29), [(768, 1024)] * 32)
    data = in_bucket(fixtures, (768, 1024))
    jpegs = [data[i % len(data)] for i in range(32)]
    out, recorded = {}, {}
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        model = TinyFacesDetector(dtype=dtype).to(dev)
        model.load_state_dict(calibrated.state_dict())
        for transfer, resample in WIRE_SETTINGS:
            tag = f"{label} {transfer}" + (" pil" if resample == "pil" else "")
            det = PyramidDetector(model, templates_np, DetectorConfig(), EvalConfig(resample=resample),
                                  device=dev, transfer=transfer)
            images = jpegs if transfer.startswith("jpegdct") else pink
            row = {}
            capture_s, pool_gib, n1_per_replay = [], 0.0, []
            for b in (1, 32):
                packed = det.pack_inputs(images[:b])
                result_of(det, packed)  # the key's first call: eager
                replayed = result_of(det, packed)  # its second: the capture, then a replay
                stats = det.graph_stats()[0]
                capture_s.append(stats["capture_s"][-1])
                n1_per_replay.append(stats["n1_launches"][-1])
                pool_gib = max(pool_gib, (stats["pool_reserved_bytes"] or 0) / 2**30)
                if b == 1:
                    with sync_errors():
                        res = det.detect_batch_async(packed)
                    for e in res.events:
                        e.synchronize()
                    with eager(det), sync_errors():
                        res = det.detect_batch_async(packed)
                    for e in res.events:
                        e.synchronize()
                with eager(det):
                    if b == 32 and transfer == "rgb" and resample == "linear":
                        with NmsRecorder() as rec:
                            plain = result_of(det, packed)
                        recorded[f"{label} b32"] = rec.calls[0]
                        recorded[f"{label} b1"] = tuple(t[:1] for t in rec.calls[0])
                    else:
                        plain = result_of(det, packed)
                same = bool(np.array_equal(replayed.view(np.uint32), plain.view(np.uint32)))
                cell = {"bit_equal": same, "equal_value_share": float((replayed == plain).mean()),
                        "dets_per_image": float(replayed[..., 5].sum(1).mean())}
                if not same:
                    shares = [iou_matched_share(g, w) for g, w in
                              zip(detections_of(replayed), detections_of(plain))]
                    cell["iou099_share"] = float(np.mean([s for s, _ in shares]))
                    cell["max_score_diff"] = max(d for _, d in shares)
                if b == 1:
                    cell["sync_debug_error_mode"] = "no sync in a replay or an eager call"
                row[f"b{b}"] = cell
                check(same or label == "bf16",
                      f"{tag} batch {b}: the replayed graph's output differs from the eager path's "
                      f"({cell['equal_value_share']:.6f} of the values equal)")
            row.update(capture_s=capture_s, pool_gib=pool_gib, n1_per_replay=n1_per_replay)
            out[tag] = row
            print(f"graph {tag}: b1 {row['b1']}, b32 {row['b32']}; batch 1 and 32 captured in "
                  f"{[round(c, 3) for c in capture_s]} s, pool up to {pool_gib:.2f} GiB, N1 "
                  f"{n1_per_replay} a replay ({name})", flush=True)
            del det
            gc.collect()
            torch.cuda.empty_cache()
        del model
    return out, recorded


def path_numbers(det: PyramidDetector, images: list, packed32, dev: torch.device, tag: str) -> dict:
    """Phase 29 (d) for one path (the detector as it is: replayed, or with
    its trace set: eager): host launch calls and device busy share per
    batch-1 call (torch.profiler, tools.device_profile), batch-1 latency
    (detect_batch, pack included, median of 20), b32 img/s (3 batches after
    a warm one), the allocator's peak over the warm one and those (the
    capture's pool included) and the memory reserved after them,
    DetectionService p50/p95/p99 at 16 req/s for 5 s
    (tools.serving_bench)."""
    r = {}
    prof = device_profile.profile(det, lambda i: images[i:i + 1], 3, GRAPH_DIR / f"trace_{tag}",
                                  eager=tag == "eager")
    r["host_launches_b1"] = prof["host_launches_per_batch"]
    r["device_launches_b1"] = prof["launches_per_batch"]
    r["busy_share_b1"] = prof["busy_share"]
    one = images[9:10]
    for _ in range(2):  # the first call, the capture
        det.detect_batch(one)
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        det.detect_batch(one)
        lat.append(1e3 * (time.perf_counter() - t0))
    r["batch1_ms"] = float(np.median(lat))
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):  # warm-up (on the replayed path: the eager first call, the capture)
        result_of(det, packed32)
    t0 = time.perf_counter()
    for _ in range(3):
        det._fetch(det.detect_batch_async(packed32))
    r["b32_img_per_s"] = 3 * 32 / (time.perf_counter() - t0)
    r["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    r["reserved_gib"] = torch.cuda.memory_reserved(dev) / 2**30
    rows = serving_bench.serve(det, images[:8], [16.0], 5.0)
    r["serving_16"] = {k: rows[0][k] for k in ("achieved", "n", "p50_ms", "p95_ms", "p99_ms", "max_ms")}
    return r


def phase_paths(calibrated: TinyFacesDetector, templates_np, fixtures: dict, dev: torch.device,
                name: str) -> dict:
    """Phase 29 (d): the eager and the replayed path side by side on the
    JPEG wire the CLI and bench default to (jpegdct, bf16, EvalConfig(),
    the 768x1024 fixtures): path_numbers for each, eager first, on one
    detector, and what its graphs cost (captures, pool)."""
    data = in_bucket(fixtures, (768, 1024))
    images = [data[i % len(data)] for i in range(32)]
    det = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                          device=dev, transfer="jpegdct")
    packed32 = det.pack_inputs(images)
    GRAPH_DIR.mkdir(parents=True, exist_ok=True)
    out = {}
    with eager(det):
        out["eager"] = path_numbers(det, images, packed32, dev, "eager")
    out["graph"] = path_numbers(det, images, packed32, dev, "graph")
    stats = det.graph_stats()[0]
    out["graph"].update(graphs=stats["graphs"], capture_s=stats["capture_s"],
                        pool_gib=(stats["pool_reserved_bytes"] or 0) / 2**30)
    for path, r in out.items():
        print(f"{path} path (jpegdct bf16 768x1024): batch-1 {r['batch1_ms']:.2f} ms (median of 20), "
              f"{r['host_launches_b1']:.0f} host launch calls and {r['device_launches_b1']:.0f} device "
              f"launches a batch-1 call, device busy {100 * r['busy_share_b1']:.1f}%; b32 "
              f"{r['b32_img_per_s']:.2f} img/s, peak {r['peak_gib']:.2f} GiB, reserved "
              f"{r['reserved_gib']:.2f} GiB; service at 16/s: p50 "
              f"{r['serving_16']['p50_ms']} p95 {r['serving_16']['p95_ms']} p99 {r['serving_16']['p99_ms']} "
              f"ms (achieved {r['serving_16']['achieved']}/s) ({name})", flush=True)
    g = out["graph"]
    print(f"graphs of this detector: {g['graphs']} (batch 1, 2, 4, 8, 16 of the service's ladder and "
          f"32), captured in {[round(c, 2) for c in g['capture_s']]} s, shared pool {g['pool_gib']:.2f} "
          f"GiB", flush=True)
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return out


def pool_gib(det: PyramidDetector) -> tuple[float, float]:
    """(reserved, allocated) GiB of the first replica's graph pool."""
    pool = tuple(det.replicas[0].cache.pool.id)
    segs = [s for s in torch.cuda.memory_snapshot() if tuple(s.get("segment_pool_id", ())) == pool]
    return (sum(s["total_size"] for s in segs) / 2**30, sum(s["allocated_size"] for s in segs) / 2**30)


def phase_fp32_buckets(calibrated: TinyFacesDetector, templates_np, dev: torch.device, name: str) -> dict:
    """Phase 29 (e): the reference precision at the CLI's eval batch (fp32,
    TF32 off, eval batch 32, EvalConfig() defaults, rgb). First the
    768x1024 key alone: its eager call and its capture, the pool's reserved
    and allocated bytes and the allocator's peak after each, the replayed
    output bit-equal to the eager one. Then evaluate_model.run over 96
    images of that bucket and then 96 of 1024x768 (three batches of 32
    each): the second bucket's first, eager batch runs beside the first
    bucket's captured graph, its second captures, its third replays. Both
    keys must stay captured (no release for memory); the result tree, the
    pool and the peak over the sweep."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(30)
    base = {hw: pink_images(rng, [hw] * 4) for hw in ((768, 1024), (1024, 768))}
    det = PyramidDetector(calibrated, templates_np, DetectorConfig(), EvalConfig(), device=dev)
    packed = det.pack_inputs(base[(768, 1024)] * 8)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out, first = {"card": name}, {}
    for step in ("eager", "capture"):
        first[step] = result_of(det, packed)
        reserved, allocated = pool_gib(det)
        out[step] = {"pool_reserved_gib": reserved, "pool_allocated_gib": allocated,
                     "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                     "reserved_gib": torch.cuda.memory_reserved(dev) / 2**30}
    check(np.array_equal(first["eager"].view(np.uint32), first["capture"].view(np.uint32)),
          "fp32 b32 768x1024: the replayed graph's output differs from the eager call's")
    items = [(base[hw][i % 4], f"{i % 4}--Event{i % 4}/fp32_{hw[0]}x{hw[1]}_{i}.jpg")
             for hw in base for i in range(96)]
    out_dir = ROOT / "build" / "chip_smoke" / "val_fp32"
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    evaluate_model.run(det, MemoryDataset(items), 0.03, 0.3, "val", results_dir=out_dir,
                       eval_batch=32, workers=4)
    files, n_dets = check_result_tree(out_dir, len(items))
    stats = det.graph_stats()[0]
    reserved, allocated = pool_gib(det)
    out["sweep"] = {"files": len(files), "detections": n_dets, "graphs": stats["graphs"],
                    "releases": stats["releases"], "capture_s": stats["capture_s"],
                    "pool_reserved_gib": reserved, "pool_allocated_gib": allocated,
                    "peak_allocated_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                    "reserved_gib": torch.cuda.memory_reserved(dev) / 2**30,
                    "img_per_s": evaluate_model.run.last_phases["images_per_sec"]}
    s = out["sweep"]
    check(s["graphs"] == 2 and s["releases"] == 0,
          f"fp32 eval batch 32 over two buckets: {s['graphs']} graphs, {s['releases']} releases for memory")
    out["phase_s"] = time.perf_counter() - t0
    e, c = out["eager"], out["capture"]
    print(f"fp32 b32 768x1024 key: after its eager call pool {e['pool_reserved_gib']:.2f} GiB reserved / "
          f"{e['pool_allocated_gib']:.2f} allocated, peak allocated {e['peak_allocated_gib']:.2f}, card "
          f"reserved {e['reserved_gib']:.2f}; after its capture pool {c['pool_reserved_gib']:.2f} / "
          f"{c['pool_allocated_gib']:.2f}, peak {c['peak_allocated_gib']:.2f}, card reserved "
          f"{c['reserved_gib']:.2f} GiB; replay bit-equal to the eager call ({name})", flush=True)
    print(f"evaluate_model.run fp32 eval batch 32, 768x1024 then 1024x768 (3 batches each): "
          f"{s['files']} result files, {s['detections']} detections, {s['graphs']} graphs captured "
          f"in {[round(x, 2) for x in s['capture_s']]} s, {s['releases']} releases, pool "
          f"{s['pool_reserved_gib']:.2f} GiB reserved / {s['pool_allocated_gib']:.2f} allocated, peak "
          f"allocated {s['peak_allocated_gib']:.2f}, card reserved {s['reserved_gib']:.2f} GiB, "
          f"{s['img_per_s']:.2f} img/s ({out['phase_s']:.1f} s; {name})", flush=True)
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_compiled_pyramid(calibrated: TinyFacesDetector, templates_np, fixtures: dict,
                           dev: torch.device, name: str) -> tuple[dict, int]:
    """Phase 29: (b, c) phase_graphs, (e) phase_fp32_buckets, (a) phase_n1
    on (b)'s recorded NMS inputs, (d) phase_paths. Returns the results and
    N1's launches on the pyramid paths of (b), (e) and (d) (replays
    counted; (a)'s comparison launches are not)."""
    t0 = time.perf_counter()
    nms_kernel.launch_count = 0
    graphs, recorded = phase_graphs(calibrated, templates_np, fixtures, dev, name)
    fp32_buckets = phase_fp32_buckets(calibrated, templates_np, dev, name)
    launches = nms_kernel.launch_count
    n1 = phase_n1(recorded, dev, name)
    del recorded
    nms_kernel.launch_count = 0
    paths = phase_paths(calibrated, templates_np, fixtures, dev, name)
    launches += nms_kernel.launch_count
    out = {"card": name, "n1": n1, "graphs": graphs, "fp32_buckets": fp32_buckets, "paths": paths,
           "phase_s": time.perf_counter() - t0}
    print(f"phase 29 (the compiled pyramid, N1) took {out['phase_s']:.1f} s, N1 launched {launches} "
          f"times on its pyramid paths ({name})", flush=True)
    return out, launches


# --- N1 against another checkout's, in turns: --n1-against, --e2e-against --


def kernel_split(fn, tag: str, trace_dir: Path, runs: int = 20) -> dict:
    """Device microseconds per call of each CUDA kernel fn() launches, by
    name: the kernel events of torch.profiler's trace over `runs` replays
    of fn captured as a CUDA graph ("graph") and over `runs` eager calls
    ("eager"). The traces go to trace_dir."""
    graph = capture_graph(fn)
    trace_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for mode, step in (("graph", graph.replay), ("eager", fn)):
        step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                step()
            torch.cuda.synchronize()
        path = trace_dir / f"n1_split_{tag}_{mode}.json"
        prof.export_chrome_trace(str(path))
        sums: dict = {}
        for e in json.loads(path.read_text()).get("traceEvents", []):
            if e.get("ph") == "X" and e.get("cat") == "kernel":
                name = e["name"].replace("(anonymous namespace)::", "").split("(")[0]
                sums[name] = sums.get(name, 0.0) + e["dur"] / runs
        check(sums, f"torch.profiler recorded no kernel of N1 ({tag}, {mode})")
        out[mode] = sums
    return out


def record_nms_inputs(calibrated: TinyFacesDetector, templates_np, dev: torch.device) -> tuple:
    """The decode outputs that phase 29 (b) records: the bf16 rgb pyramid of
    phase 5's model on its 32 pink 768x1024 images, eager, as handed to
    batched_nms_padded (boxes, scores, valid)."""
    pink = pink_images(np.random.default_rng(29), [(768, 1024)] * 32)
    det = PyramidDetector(bf16_copy(calibrated, dev), templates_np, DetectorConfig(), EvalConfig(),
                          device=dev, transfer="rgb")
    packed = det.pack_inputs(pink)
    with eager(det), NmsRecorder() as rec:
        result_of(det, packed)
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return rec.calls[0]


def record_bench_nms_inputs(dev: torch.device) -> tuple:
    """The decode outputs that bench's detector (seeded bf16 weights, not
    recalibrated, `jpegdct`) hands batched_nms_padded for bench's 32 JPEG
    images: phase 22's regime, where every candidate is valid and most are
    kept."""
    det = instrument_detector(dev, transfer="jpegdct")
    packed = det.pack_inputs(bench_mod.bench_inputs("jpegdct", 32, 768, 1024))
    with eager(det), NmsRecorder() as rec:
        result_of(det, packed)
    del det
    gc.collect()
    torch.cuda.empty_cache()
    return rec.calls[0]


def n1_timed_inputs(recorded: tuple, dev: torch.device) -> dict:
    """N1's timed inputs, rank-sorted: the bf16 decode outputs at batch 32
    and 1; 32 clustered scenes of 4000 candidates with every row valid; and
    bench's decode outputs at batch 32 and 1 (record_bench_nms_inputs)."""
    boxes_s, valid_s = rank_for_nms(*recorded)
    rng = np.random.default_rng(31)
    full = [torch.from_numpy(np.stack(x)).to(dev)
            for x in zip(*[clustered_scene(rng, 4000, 4000) for _ in range(32)])]
    bench_s = rank_for_nms(*record_bench_nms_inputs(dev))
    return {"bf16 B32": (boxes_s, valid_s), "bf16 B1": (boxes_s[:1], valid_s[:1]),
            "all valid B32": rank_for_nms(*full), "bench B32": bench_s,
            "bench B1": tuple(x[:1] for x in bench_s)}


# One turn of --n1-against, run in a child from a checkout's root with
# `python -c`, so it takes that checkout's N1 through the wrapper's
# contract, nms_kernel._launch(boxes, valid, threshold) -> keep, whatever
# its C entry point: on the rank-sorted inputs saved at argv[1], the keep
# masks at threshold 0.3 (saved to argv[2]), the device time of a graph
# replay (graph_ms) and the split by kernel (kernel_split, traces to
# argv[3], tagged argv[4]). The helpers are this script's own.
N1_TURN = """
import json, sys
from pathlib import Path
import numpy as np
import torch
from tinyfaces_tpu_torch.ops import nms_kernel
{helpers}
out, keeps = {{}}, {{}}
for label, (bx, vd) in torch.load(sys.argv[1]).items():
    bx, vd = bx.cuda().contiguous(), vd.cuda().contiguous()
    fn = lambda: nms_kernel._launch(bx, vd, 0.3)
    keeps[label] = fn().cpu()
    out[label] = {{"device_ms": graph_ms(fn),
                  "split_us": kernel_split(fn, label.replace(" ", "_") + "_" + sys.argv[4], Path(sys.argv[3]))}}
torch.save(keeps, sys.argv[2])
print(json.dumps(out))
"""


def n1_against(checkout: Path, recorded: tuple, dev: torch.device, name: str) -> dict:
    """`--n1-against DIR`, after phase_n1: N1_TURN from DIR and from this
    checkout in turns (other, this, this, other), each in a child process,
    on n1_timed_inputs of the `recorded` decode outputs: every turn's keep
    masks bit-equal to this process's N1, each turn's graph-replay device
    time (CUDA events, median of 20) and split by kernel, with nms_bound."""
    inputs = {label: (bx.contiguous(), vd.contiguous())
              for label, (bx, vd) in n1_timed_inputs(recorded, dev).items()}
    keep = {label: nms_kernel._launch(bx, vd, 0.3) for label, (bx, vd) in inputs.items()}
    work = ROOT / "build" / "chip_smoke" / "n1_turns"
    work.mkdir(parents=True, exist_ok=True)
    torch.save({label: (bx.cpu(), vd.cpu()) for label, (bx, vd) in inputs.items()}, work / "inputs.pt")
    code = N1_TURN.format(helpers="\n\n".join(inspect.getsource(f) for f in (check, cuda_ms, capture_graph,
                                                                                graph_ms, kernel_split)))
    turns = []
    for i, (who, cwd) in enumerate((("other", checkout), ("this", ROOT), ("this", ROOT), ("other", checkout))):
        keeps = work / f"keep{i}_{who}.pt"
        proc = subprocess.run([sys.executable, "-c", code, str(work / "inputs.pt"), str(keeps), str(GRAPH_DIR),
                               f"turn{i}_{who}"], cwd=cwd.resolve(), capture_output=True, text=True,
                              timeout=600, env={**os.environ, "PYTHONPATH": str(cwd.resolve())})
        (work / f"turn{i}_{who}.log").write_text(proc.stdout + proc.stderr)
        check(proc.returncode == 0, f"N1 turn {i} ({who}, {cwd}) exited {proc.returncode}:\n"
                                    f"{proc.stderr[-3000:]}")
        got = torch.load(keeps)
        for label, k in keep.items():
            check(torch.equal(got[label], k.cpu()), f"N1 {label}: turn {i}'s ({who}, {cwd}) keep mask differs "
                                                    f"from this process's")
        turns.append((who, json.loads(proc.stdout.strip().splitlines()[-1])))
    out = {"card": name}
    for label, (bx, vd) in inputs.items():
        ext = nms_kernel.valid_extent(vd)
        bound = nms_kernel.nms_bound(vd, keep[label])
        ms = [(who, t[label]["device_ms"]) for who, t in turns]
        out[label] = {"turns_device_ms": ms, "split_us": [(who, t[label]["split_us"]) for who, t in turns],
                      "valid_extent_mean": float(ext.float().mean()), "valid_extent_max": int(ext.max()),
                      **bound}
        print(f"N1 {label} (extent mean {float(ext.float().mean()):.0f}, max {int(ext.max())}, kept "
              f"{bound['kept']}): device ms in turns {[(w, round(t, 4)) for w, t in ms]}; split (us a call) "
              f"{json.dumps(out[label]['split_us'])}; bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}, "
              f"{bound['needed_pairs']} tests) ({name})", flush=True)
    return out


# One turn of --e2e-against, run in a child from a checkout's root with
# `python -c`, so it imports that checkout's package: bench.run as
# `python -m tinyfaces_tpu_torch.bench` runs it (b32 jpegdct, seeded bf16
# weights, 8 batches a window, depth 3, 5 windows), bench's batch-1
# latency split again over 50 images (host pack, enqueue, and the wait for
# the replayed pyramid and its copy back), then the detector's graph pool.
E2E_TURN = """
import json, torch
from tinyfaces_tpu_torch import bench
from tinyfaces_tpu_torch.utils.instruments import build_detector, card
dev = torch.device("cuda", 0)
det = build_detector(dev, transfer="jpegdct")
inputs = bench.bench_inputs("jpegdct", 32, 768, 1024)
out = bench.run(det, inputs, iters=8, depth=3, windows=5)
lat = bench.latency_split(det, inputs, runs=50)
s = det.graph_stats()[0]
print(json.dumps({"img_per_s": out["value"], "window_rates": out["window_rates"],
                  "batch1_ms": out["batch1"]["total_ms"], "batch1_50": lat, "peak_gib": out["peak_gib"],
                  "pool_gib": s["pool_reserved_bytes"] / 2**30, "graphs": s["graphs"],
                  "card": card(dev)}))
"""


def e2e_against(checkout: Path, name: str) -> list:
    """`--e2e-against DIR`: E2E_TURN from DIR and from this checkout in
    turns (other, this, this, other, twice), each in a child process with
    the card to itself: b32 jpegdct img/s, batch-1 latency (replayed) and
    its parts, peak memory and the graph pool's GiB."""
    rows = []
    log_dir = ROOT / "build" / "chip_smoke" / "e2e_turns"
    log_dir.mkdir(parents=True, exist_ok=True)
    for i, (who, cwd) in enumerate((("other", checkout), ("this", ROOT), ("this", ROOT),
                                    ("other", checkout)) * 2):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", E2E_TURN], cwd=cwd.resolve(), capture_output=True,
                              text=True, timeout=900, env={**os.environ, "PYTHONPATH": str(cwd.resolve())})
        (log_dir / f"turn{i}_{who}.log").write_text(proc.stdout + proc.stderr)
        check(proc.returncode == 0, f"e2e turn {i} ({who}, {cwd}) exited {proc.returncode}:\n"
                                    f"{proc.stderr[-3000:]}")
        row = {"who": who, **json.loads(proc.stdout.strip().splitlines()[-1]),
               "turn_s": time.perf_counter() - t0}
        rows.append(row)
        b1 = row["batch1_50"]
        print(f"e2e turn {i} ({who}): b32 jpegdct {row['img_per_s']:.3f} img/s (windows "
              f"{[round(r, 2) for r in row['window_rates']]}), batch-1 {row['batch1_ms']:.2f} ms "
              f"(median of 5), over 50 {b1['total_ms']:.2f} ms = pack {b1['pack_ms']:.2f} + enqueue "
              f"{b1['enqueue_ms']:.2f} + wait {b1['wait_ms']:.2f}, "
              f"peak {row['peak_gib']:.3f} GiB, graph pool {row['pool_gib']:.4f} GiB over "
              f"{row['graphs']} graphs ({row['card']}; {row['turn_s']:.0f} s)", flush=True)
    return rows


WORKERS = {"dist_steps": worker_dist_steps, "stop": worker_stop, "eval": worker_eval}


def main() -> None:
    if sys.argv[1:2] == ["--worker"]:  # one rank of phases 19-21, started by spawn_ranks
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        WORKERS[sys.argv[2]](*sys.argv[3:])
        return
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout: its K1 is built and timed in turns with this one")
    ap.add_argument("--spatial-only", action="store_true",
                    help="phase 26 alone, after its set-up (phase 5's calibrated model, phase "
                         "13's tree), e.g. over four cards")
    ap.add_argument("--compiled-only", action="store_true",
                    help="phase 29 alone, after its set-up (phase 5's calibrated model, the JPEG "
                         "fixtures)")
    ap.add_argument("--capture-only", action="store_true",
                    help="phases 27 and 30 alone: the captured train step of make_multi_train_step "
                         "and of Trainer.train_step")
    ap.add_argument("--n1-against", type=Path, default=None,
                    help="another checkout: after phase 5's set-up, phase 29 (a) on the bf16 decode "
                         "outputs, then both checkouts' N1 timed and split by kernel in turns on them, "
                         "each turn a child process, then exit")
    ap.add_argument("--e2e-against", type=Path, default=None,
                    help="another checkout: bench b32 jpegdct, batch-1 latency and the graph pool "
                         "of both in turns, each in a child process, then exit")
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
    builds = [assignment_kernel._kernel, nms_kernel._kernel, native.load, jpegdct.load]
    if args.against is not None:
        builds.append(lambda: build_against(args.against))
    with ThreadPoolExecutor(len(builds)) as pool:  # nvcc and the host compiler side by side
        built = [f.result() for f in [pool.submit(build) for build in builds]]
    against = built[4] if args.against is not None else None
    print(f"build: dense_assignment.cu and nms.cu (nvcc), tinyfaces_native.cpp and jpeg_dct.cpp (host C++) "
          f"compiled and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    templates_np = load_templates()
    if args.n1_against is not None or args.e2e_against is not None:
        out = {}
        if args.e2e_against is not None:  # first: the children need the card to themselves
            out["e2e_turns"] = e2e_against(args.e2e_against, name)
        if args.n1_against is not None:
            model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0)).to(dev)
            calibrate(model, pink_images(np.random.default_rng(5), [(192, 256), (176, 248)]), dev)
            rec = record_nms_inputs(model, templates_np, dev)
            del model
            out["n1"] = phase_n1({"bf16 b32": rec, "bf16 b1": tuple(t[:1] for t in rec)}, dev, name)
            out["n1_turns"] = n1_against(args.n1_against, rec, dev, name)
        print(json.dumps(out))
        print(name)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    if args.spatial_only:
        model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0)).to(dev)
        calibrate(model, pink_images(np.random.default_rng(5), [(192, 256), (176, 248)]), dev)
        phase_dct_sweep_and_service(model, templates_np, load_fixtures(), dev)
        spatial = phase_spatial(model, templates_np, dev, name)
        print(f"phase 26 passed in {time.perf_counter() - start:.1f} s ({name})", flush=True)
        print(json.dumps({"spatial": spatial}))
        print(name)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    if args.capture_only:
        multi, _ = phase_multi(templates_np, dev, name)
        captured, _ = phase_trainer_capture(templates_np, dev, name)
        print(f"phases 27 and 30 passed in {time.perf_counter() - start:.1f} s ({name})", flush=True)
        print(json.dumps({"multi": multi, "trainer_capture": captured}))
        print(name)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    if args.compiled_only:
        model = init_model(TinyFacesDetector(), torch.Generator().manual_seed(0)).to(dev)
        calibrate(model, pink_images(np.random.default_rng(5), [(192, 256), (176, 248)]), dev)
        compiled, n1_graph_launches = phase_compiled_pyramid(model, templates_np, load_fixtures(), dev, name)
        check(n1_graph_launches > 0, "phase 29's pyramids did not launch N1")
        print(f"phase 29 passed in {time.perf_counter() - start:.1f} s ({name})", flush=True)
        print(json.dumps({"compiled_pyramid": compiled}))
        print(name)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
        return
    templates = torch.tensor(templates_np, dtype=torch.float32, device=dev)
    kres = phase_kernel(templates, dev, name, against)
    trainer, dataset, launches = phase_train(templates_np, dev, name)
    phase_checkpoint(trainer, dataset, templates_np, dev)
    del trainer, dataset
    torch.cuda.empty_cache()
    t_dist = time.perf_counter()
    dist_result = {"card": name}
    dist_result["world_n"], world_n_launches = phase_world_n(dev, name)
    dist_result["agreed_stop"], stop_launches = phase_agreed_stop(name)
    t_dist = time.perf_counter() - t_dist

    nms_kernel.launch_count = 0
    model, vs_cpu = phase_inference_vs_cpu(templates_np, dev)
    full = phase_full_width(model, templates_np, dev, name)
    served = phase_sweep_and_service(model, templates_np, dev)
    n1_launches = nms_kernel.launch_count
    check(n1_launches > 0, "phases 5-7 ran the pyramid on the card without launching N1")
    t0 = time.perf_counter()
    dist_result["eval"] = phase_eval_distributed(model, templates_np, dev, name)
    t_dist += time.perf_counter() - t0
    fixtures = load_fixtures()
    dct = {"card": name, "fixtures": phase_jpeg_fixtures(fixtures),
           "unpack_vs_cpu": phase_unpack_vs_cpu(fixtures, dev),
           "gpu_vs_cpu": phase_dct_pyramid_vs_cpu(model, templates_np, fixtures, dev),
           "bf16": phase_dct_full_width(model, templates_np, fixtures, dev, name),
           **phase_dct_sweep_and_service(model, templates_np, fixtures, dev)}
    accuracy = {"card": name, "pil_resize": phase_pil_resize(dev),
                "pil_pyramid": phase_pil_pyramid(model, templates_np, dev, name)}
    t0 = time.perf_counter()
    wires = {"card": name, "fold": phase_fold(model, templates_np, dev, name),
             "yuv420": phase_yuv420(model, templates_np, dev, name),
             "jpegdct4": phase_jpegdct4(model, templates_np, fixtures, dev, name)}
    t_wires = time.perf_counter() - t0
    t0 = time.perf_counter()
    slice10 = {"spatial": phase_spatial(model, templates_np, dev, name)}
    t_slice10 = time.perf_counter() - t0
    compiled, n1_graph_launches = phase_compiled_pyramid(model, templates_np, fixtures, dev, name)
    check(n1_graph_launches > 0, "phase 29's pyramids did not launch N1")
    del model
    torch.cuda.empty_cache()
    train_cli_result, cli_launches, ann, train_set = phase_train_cli(templates_np, dev, name)
    t0 = time.perf_counter()
    dist_result["world1_group"], group_launches = phase_world1_group(ann, train_set, dev, name)
    t_dist += time.perf_counter() - t0
    t0 = time.perf_counter()
    wires["yuv420"]["train_cli"], yuv_launches = phase_train_cli_yuv420(ann, train_set, dev, name)
    wires["phases_23_25_s"] = t_wires + time.perf_counter() - t0
    del train_set
    dct["train_cli"], dct_launches = phase_train_cli_jpegdct(templates_np, fixtures, dev, name)
    gc.collect()
    torch.cuda.empty_cache()  # the children of phase 17 have the card to themselves
    accuracy["closed_loop"], e2e_launches = phase_closed_loop(dev, name)
    instruments, instrument_launches = phase_instruments(dev, name, dct["bf16"]["img_per_s"])
    t0 = time.perf_counter()
    slice10["multi"], multi_launches = phase_multi(templates_np, dev, name)
    slice10["trainer_capture"], capture_launches = phase_trainer_capture(templates_np, dev, name)
    slice10["tools"] = phase_tools(name)
    slice10["phases_26_28_s"] = t_slice10 + time.perf_counter() - t0
    dist_result["phases_18_21_s"] = t_dist
    print(f"phases 18-21 (multi-process training and evaluation) took {t_dist:.1f} s", flush=True)
    print(f"phases 23-25 (the folded stem, yuv420, jpegdct4) took {wires['phases_23_25_s']:.1f} s",
          flush=True)
    print(f"phases 26-28 (spatial, multi, tools) took {slice10['phases_26_28_s']:.1f} s", flush=True)
    print(f"all phases passed in {time.perf_counter() - start:.1f} s ({name})", flush=True)
    print(json.dumps({"inference": {"card": name, "gpu_vs_cpu": vs_cpu, **full, **served}}))
    print(json.dumps({"train_cli": train_cli_result}))
    print(json.dumps({"jpegdct": dct}))
    print(json.dumps({"accuracy": accuracy}))
    print(json.dumps({"distributed": dist_result}))
    print(json.dumps({"wires": wires}))
    print(json.dumps({"instruments": instruments}))
    print(json.dumps({"spatial_multi_tools": slice10}))
    print(json.dumps({"compiled_pyramid": compiled}))
    n1 = compiled["n1"]
    print(json.dumps({"kernels": [{
        "name": "dense_assignment_reductions",
        "route": "cuda",
        "source": "tinyfaces_tpu_torch/csrc/dense_assignment.cu",
        "replaces": "tinyfaces_tpu/ops/pallas_assignment.py:209",
        "launches": (launches + cli_launches + dct_launches + e2e_launches + group_launches
                     + world_n_launches + stop_launches + instrument_launches + yuv_launches
                     + multi_launches + capture_launches),
        "launches_by_path": {"train_epoch": launches, "train_cli": cli_launches,
                             "train_cli_jpegdct": dct_launches, "train_cli_yuv420": yuv_launches,
                             "e2e_train_yuv420": e2e_launches,
                             "train_cli_world1_group": group_launches,
                             "world_n_all_ranks_and_world1_replays": world_n_launches, "agreed_stop_all_ranks": stop_launches,
                             "instruments": instrument_launches, "train_multi": multi_launches,
                             "train_captured_route": capture_launches},
        "max_abs_err": kres["max_abs_err"],
        **kres[f"G{DetectorConfig().max_gt}"],
        "library_ms": None,  # no single PyTorch call computes it
        "train_like": kres["train_like"],
    }, {
        "name": "nms_keep",
        "route": "cuda",
        "source": "tinyfaces_tpu_torch/csrc/nms.cu",
        "replaces": "tinyfaces_tpu/ops/nms.py:42,119 (the JAX NMS's device loops; not a Pallas kernel)",
        "design": "one launch, a cluster of up to 8 blocks an image (launch_shape); boxes, dead-row bitset "
                  "and per-warp live lists in shared memory; 64-row chunks resolved by the leader, forward "
                  "suppression by kept rows",
        "launches": n1_launches + n1_graph_launches,
        "launches_by_path": {"pyramid_phases_5_7": n1_launches,
                             "compiled_pyramid_phase_29": n1_graph_launches},
        "max_abs_err": n1["max_abs_err"],
        "ms": n1["bf16 B32"]["ms"], "device_ms": n1["bf16 B32"]["device_ms"],
        "plain_ms": n1["bf16 B32"]["plain_ms"],
        "blocked_reference_ms": n1["bf16 B32"]["blocked_reference_ms"],
        "bound_ms": n1["bf16 B32"]["bound_ms"], "bound_by": n1["bf16 B32"]["bound_by"],
        "library_ms": None,  # no torchvision on the machine; no other single call computes it
        "B1": n1["bf16 B1"], "all_valid_B32": n1["all valid B32"], "bench_B32": n1["bench B32"],
        "bench_B1": n1["bench B1"],
    }]}))
    print(name)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

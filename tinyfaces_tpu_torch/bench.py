"""Benchmark: WIDER-style image-pyramid inference throughput on one card.

    python -m tinyfaces_tpu_torch.bench [--device cuda]

Port of the root bench.py. It measures the pipeline the reference runs per
val image (evaluate_model.py -> evaluation.py:20-87): pyramid scales
2**{-2..1} over a 1024x768 image, a ResNet-101 FCN forward per scale,
decode and cross-scale NMS on the device, host work and transfers
included. The model has seeded weights in bf16 with `EvalConfig()`
defaults; the inputs are JPEG files (quality 90, 4:2:0) of images with
natural-photo spectral statistics, the format WIDER images arrive in.

The wire is `jpegdct` by default: the host entropy-decodes the JPEG (C++,
threaded) and ships quantized DCT coefficients; the card dequantizes,
inverts the DCT, upsamples chroma and normalizes before the pyramid.
BENCH_TRANSFER=jpegdct4 ships the bitmap-sparse wire v4 of the same files;
rgb ships the decoded uint8 pixels and yuv420 them as planar YCbCr 4:2:0
(converted on the host in the pack thread).

Two host stages keep BENCH_DEPTH batches in flight: a pack thread
(`PyramidDetector.pack_inputs`) and an upload + dispatch thread
(`detect_batch_async`), fetched in order with `_fetch`. The batch order
rotates on every dispatch, so no two batches are equal. After one warm
window the result is the median of BENCH_WINDOWS windows of BENCH_ITERS
batches; every window's rate goes to stderr. Knobs: BENCH_BATCH (32),
BENCH_ITERS (256 // batch), BENCH_DEPTH (3), BENCH_WINDOWS (5),
BENCH_QUALITY (90), BENCH_CONTENT (natural; or smooth, texture, graphics
from tools.wire_stats).

Prints ONE JSON line last on stdout: {"metric", "value", "unit",
"vs_baseline"}. On stderr: the card's name and power limit, the wire's
B/px, an 8 MiB pinned host-to-device copy timed with CUDA events, warm-up
seconds, the window rates, batch-1 latency with its host pack, enqueue and
wait, then the eager path's batch-1 split into upload and device (CUDA
events), peak memory from the first call on (the warm-up and, on a GPU,
the captures included), and FLOP/image with the achieved TFLOP/s
(tools.profile_model). On a GPU the timed batches and the batch-1 latency
replay the pyramid's CUDA graph (one per batch shape, captured at its second
call); the CUDA-event split needs the eager run, which a traced batch takes
(evaluation.PyramidDetector), so it is labelled as the eager path's.

Baseline: the reference publishes no throughput numbers (BASELINE.md). We
use a FLOPs-derived estimate of the reference PyTorch pipeline on an A100:
the pyramid costs ~5.3x a single 768x1024 forward (~0.25 TFLOP) ≈ 1.3
TFLOP/image; fp32 PyTorch conv throughput w/ host decode round-trips ≈ 4
TFLOP/s sustained -> ~3 images/sec. vs_baseline = ours / 3.0.

Not ported, as they only work around the TPU's remote link: the backend
probe, the compilation cache, the D2H warm-up, the exit workaround and the
"max plateau" gate for a multi-tenant link.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES

BASELINE_IMGS_PER_SEC = 3.0  # estimated reference-on-A100 (see docstring)
METRIC = "pyramid_inference_images_per_sec_per_chip"
TRANSFERS = ("jpegdct", "jpegdct4", "rgb", "yuv420")


def natural_images(n, h, w, seed=0):
    """Synthetic photos with natural spectral statistics — smooth base +
    luma-dominant texture (real photo chroma is much smoother than luma;
    full-amplitude 3-channel noise would be a pathological chroma
    spectrum no camera produces) — so JPEG entropy and the jpegdct wire
    behavior are realistic rather than worst-case. The same arrays as the
    root bench.py's for the same arguments."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / 97.0) + 40 * np.cos(yy / 61.0)
    out = []
    for _ in range(n):
        tex = np.kron(rng.normal(0, 18, (h // 8, w // 8, 1)),
                      np.ones((8, 8, 1)))
        ctex = np.kron(rng.normal(0, 5, (h // 16, w // 16, 3)),
                       np.ones((16, 16, 1)))
        out.append(np.clip(base[..., None] + tex + ctex + [12, 0, -12],
                           0, 255).astype(np.uint8))
    return out


def bench_inputs(transfer: str, batch: int, h: int, w: int, quality: int = 90,
                 content: str = "natural") -> list:
    """The batch the bench rotates: JPEG bytes on the JPEG wires, arrays on
    rgb and yuv420."""
    if content == "natural":
        images = natural_images(batch, h, w)
    else:
        from tinyfaces_tpu_torch.tools.wire_stats import content_images

        images = content_images(content, batch, h, w)
    if transfer.startswith("jpegdct"):
        from tinyfaces_tpu_torch.utils.instruments import jpeg_bytes

        return jpeg_bytes(images, quality)
    return images


def wire_bytes_per_px(transfer: str, h: int, w: int) -> float:
    """Upload bytes a pixel of an h x w canvas on `transfer`."""
    from tinyfaces_tpu_torch.data import jpegdct
    from tinyfaces_tpu_torch.evaluation import WIRE_VERSION

    if transfer in WIRE_VERSION:
        return jpegdct.layout_of(WIRE_VERSION[transfer])(h, w)["__total__"] / (h * w)
    return 1.5 if transfer == "yuv420" else 3.0


def h2d_probe_mibps(dev: torch.device, mib: int = 8) -> float | None:
    """MiB/s of one pinned host-to-device copy of `mib` MiB (CUDA events,
    after one warm copy); None on the CPU."""
    if dev.type != "cuda":
        return None
    rng = np.random.default_rng(1)
    warm = torch.from_numpy(rng.integers(0, 255, (mib << 20,), np.uint8)).pin_memory()
    warm.to(dev, non_blocking=True)
    src = torch.from_numpy(rng.integers(0, 255, (mib << 20,), np.uint8)).pin_memory()
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    src.to(dev, non_blocking=True)
    end.record()
    end.synchronize()
    return mib / (start.elapsed_time(end) / 1e3)


def latency_split(det, inputs: Sequence, runs: int = 5) -> dict:
    """Batch-1 latency, median of `runs` distinct images after one warm-up,
    and its parts: host pack, the host's enqueue of the pyramid and the
    wait for the result (host clock). On a GPU the same again on the eager
    path (`eager_*`, the detector's trace set) with its upload and device
    time (CUDA events from before the upload to after it, and from there to
    the copy of the detections back): the replayed graph has no phase
    marks."""
    cuda = det.devices[0].type == "cuda"

    def timed(trace: bool) -> dict:
        for _ in range(2):  # warm-up: batch 1's first call, then its capture
            det.detect_batch([inputs[-1]])
        rows = []
        for i in range(runs):
            t0 = time.perf_counter()
            packed = det.pack_inputs([inputs[i % len(inputs)]])
            t1 = time.perf_counter()
            if trace:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                det.trace = [("start", start)]
            pending = det.detect_batch_async(packed)
            t2 = time.perf_counter()
            det._fetch(pending)
            t3 = time.perf_counter()
            row = {"total_ms": 1e3 * (t3 - t0), "pack_ms": 1e3 * (t1 - t0),
                   "enqueue_ms": 1e3 * (t2 - t1), "wait_ms": 1e3 * (t3 - t2)}
            if trace:
                marks = dict(det.trace)
                row["upload_ms"] = start.elapsed_time(marks["upload"])
                row["device_ms"] = marks["upload"].elapsed_time(marks["d2h"])
            rows.append(row)
        return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}

    out = timed(False)
    if cuda:
        try:
            out.update({f"eager_{k}": v for k, v in timed(True).items()})
        finally:
            det.trace = None
    return out


def run(det, inputs: Sequence, *, iters: int, depth: int = 3, windows: int = 5) -> dict:
    """The bench on a built detector over the batch `inputs` (rotated per
    dispatch): warm-up, batch-1 latency split, one warm window, then
    `windows` timed windows of `iters` batches with `depth` in flight."""
    dev = det.devices[0]
    batch = len(inputs)
    rot = [0]

    def make_inputs():
        k = rot[0] % batch
        rot[0] += 1
        return list(inputs[k:]) + list(inputs[:k])

    from tinyfaces_tpu_torch.utils.instruments import peak_gib, reset_peak

    # from the first call on: a replayed graph allocates nothing, its
    # capture takes the memory
    reset_peak(dev)
    t0 = time.perf_counter()
    det.detect_batch(make_inputs())
    warmup_s = time.perf_counter() - t0
    latency = latency_split(det, inputs)

    pack_pool = ThreadPoolExecutor(1)  # CPU-bound host pack, runs ahead
    submit = ThreadPoolExecutor(1)  # keeps the upload + dispatch order

    def run_window():
        q = collections.deque()
        packs = collections.deque()
        t0 = time.perf_counter()
        for i in range(iters):
            # pack runs at most depth+1 batches ahead of the fetch loop
            packs.append(pack_pool.submit(lambda: det.pack_inputs(make_inputs())))
            if len(packs) <= depth and i < iters - 1:
                continue
            p = packs.popleft()
            q.append(submit.submit(lambda p=p: det.detect_batch_async(p.result())))
            if len(q) > depth:
                det._fetch(q.popleft().result())
        while packs:
            p = packs.popleft()
            q.append(submit.submit(lambda p=p: det.detect_batch_async(p.result())))
        last = None
        while q:
            last = det._fetch(q.popleft().result())[-1]
        return iters * batch / (time.perf_counter() - t0), last

    try:
        warm_rate, _ = run_window()
        rates, last = [], None
        for _ in range(windows):
            r, last = run_window()
            rates.append(r)
    finally:
        pack_pool.shutdown()
        submit.shutdown()
    return {"value": float(np.median(rates)), "window_rates": rates, "warm_window_rate": warm_rate,
            "warmup_s": warmup_s, "batch1": latency, "peak_gib": peak_gib(dev),
            "last_image_detections": int(last.shape[0])}


def result_line(value: float) -> dict:
    return {"metric": METRIC, "value": round(value, 3), "unit": "images/sec/chip",
            "vs_baseline": round(value / BASELINE_IMGS_PER_SEC, 3)}


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES, hw: tuple = (768, 1024)) -> dict:
    """The CLI. `stage_sizes` and `hw` are the published ResNet-101 and the
    768x1024 canvas; only tests shrink them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.data import jpegdct
    from tinyfaces_tpu_torch.tools.profile_model import achieved, pyramid_flops
    from tinyfaces_tpu_torch.utils.instruments import (build_detector, card, check_transfer,
                                                       device_name, resolve_device)

    transfer = os.environ.get("BENCH_TRANSFER", "jpegdct")
    check_transfer(transfer, TRANSFERS)
    dev = resolve_device(args.device)
    name = card(dev)
    batch = int(os.environ.get("BENCH_BATCH", "32"))
    iters = int(os.environ.get("BENCH_ITERS", str(max(2, 256 // batch))))
    depth = int(os.environ.get("BENCH_DEPTH", "3"))
    windows = int(os.environ.get("BENCH_WINDOWS", "5"))
    quality = int(os.environ.get("BENCH_QUALITY", "90"))
    content = os.environ.get("BENCH_CONTENT", "natural")
    h, w = hw

    inputs = bench_inputs(transfer, batch, h, w, quality, content)
    det = build_detector(dev, transfer=transfer, stage_sizes=stage_sizes)
    wire_bpx = wire_bytes_per_px(transfer, h, w)
    link = h2d_probe_mibps(dev)
    out = run(det, inputs, iters=iters, depth=depth, windows=windows)
    levels = [det._level_canvas(h, w, s) for s in det.ec.scales]
    flops = pyramid_flops(levels, stage_sizes)
    kind = "bf16"
    out.update(transfer=transfer, batch=batch, iters=iters, depth=depth, card=name,
               wire_Bpx=wire_bpx, h2d_probe_MiBps=link, flops_per_image=flops,
               **achieved(flops, out["value"], device_name(dev), kind))
    lat = out["batch1"]
    split = (f"; eager path (traced): {lat['eager_total_ms']:.2f} ms, upload "
             f"{lat['eager_upload_ms']:.2f} ms, device {lat['eager_device_ms']:.2f} ms (CUDA events), "
             f"host enqueue {lat['eager_enqueue_ms']:.2f} ms"
             if "eager_upload_ms" in lat else "")
    share = f", {100 * out['share_of_peak']:.1f}% of the {kind} peak" if out["share_of_peak"] else ""
    print(f"# {name}; transfer={transfer} wire {wire_bpx:.3f} B/px; H2D probe "
          + (f"{link:.0f} MiB/s (8 MiB pinned, CUDA events); " if link else "not measured (cpu); ")
          + f"warm-up {out['warmup_s']:.1f} s; window rates "
          f"{[round(r, 2) for r in out['window_rates']]} img/s (median of {windows} after one warm "
          f"window of {out['warm_window_rate']:.2f}); batch-1 latency {lat['total_ms']:.2f} ms: host "
          f"pack {lat['pack_ms']:.2f} ms, host enqueue {lat['enqueue_ms']:.2f} ms, wait "
          f"{lat['wait_ms']:.2f} ms{split} (medians of 5); peak memory "
          + (f"{out['peak_gib']:.2f} GiB" if out["peak_gib"] is not None else "not measured (cpu)")
          + f"; {flops / 1e12:.4f} TFLOP/image -> {out['tflops']:.2f} TFLOP/s{share}; last image "
          f"{out['last_image_detections']} detections"
          + (f"; truncation {jpegdct.truncation_stats()}" if transfer.startswith("jpegdct") else ""),
          file=sys.stderr, flush=True)
    print(json.dumps(out), file=sys.stderr, flush=True)  # the same, for scripts
    print(json.dumps(result_line(out["value"])), flush=True)
    return out


if __name__ == "__main__":
    main()

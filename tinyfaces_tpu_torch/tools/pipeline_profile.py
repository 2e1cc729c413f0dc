"""Decompose the fused pyramid's end-to-end time on the `rgb` wire into host
prep, upload, device compute, fetch, and measure pipelining at depths 1-4.

    python -m tinyfaces_tpu_torch.tools.pipeline_profile [--batch 16] [--device cuda]

Port of tools/pipeline_profile.py, over uint8 768x1024 images of uniform
noise, bf16, `EvalConfig()` defaults:

1. host prep: `pack_inputs` (the canvas into pinned memory), host clock;
2. upload: the canvas's host-to-device copy, CUDA events (MiB/s);
3. device compute on the resident canvas: the fused pyramid alone,
   CUDA events;
4. fetch: the (B, K, 6) detections' copy back (CUDA events) and the host's
   split of them (`_fetch`, host clock);
5. serial `detect_batch`, host clock;
6. `detect_batch_async` with 1-4 batches in flight, host clock.

Each is the mean of `--reps` runs after a warm-up. On the CPU the CUDA-event
rows are not measured (None).
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from typing import Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES


def _host_ms(fn, reps: int) -> float:
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return 1e3 * (time.perf_counter() - t0) / reps


def decompose(det, images: Sequence[np.ndarray], reps: int = 5, depths=(1, 2, 3, 4),
              iters: int = 8) -> dict:
    """The six measurements of the module docstring for one batch."""
    from tinyfaces_tpu_torch.utils.instruments import cuda_events_ms

    replica = det.replicas[0]
    dev = replica.device
    cuda = dev.type == "cuda"
    b = len(images)
    det.detect_batch(images)  # warm-up
    out = {"batch": b, "reps": reps}

    out["host_prep_ms"] = _host_ms(lambda: det.pack_inputs(images), reps)
    packed = det.pack_inputs(images)
    nbytes = packed.host.numel()
    out["canvas_MiB"] = nbytes / 2**20
    if cuda:
        out["h2d_ms"] = cuda_events_ms(lambda: packed.host.to(dev, non_blocking=True), reps)
        out["h2d_MiBps"] = out["canvas_MiB"] / (out["h2d_ms"] / 1e3)
    else:
        out["h2d_ms"] = out["h2d_MiBps"] = None

    scales = tuple(det.ec.scales)
    meta = det._level_sizes(packed.hs, packed.ws, scales)
    images_d = packed.host.to(dev)
    size_hw = torch.from_numpy(np.stack([packed.hs, packed.ws], 1).astype(np.int64)).to(dev)
    level_hw = torch.from_numpy(meta).to(dev)

    def compute():
        with torch.no_grad():
            return det._fused_pyramid(replica, images_d, size_hw, level_hw, scales=scales,
                                      h0p=packed.h0p, w0p=packed.w0p,
                                      prob_thresh=float(det.ec.prob_thresh),
                                      nms_thresh=float(det.ec.nms_thresh), mark=lambda phase: None)

    result = compute()
    if cuda:
        out["device_compute_ms"] = cuda_events_ms(compute, reps)
        host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
        out["d2h_ms"] = cuda_events_ms(lambda: host.copy_(result, non_blocking=True), reps)
        out["output_KiB"] = result.numel() * result.element_size() / 2**10
    else:
        out["device_compute_ms"] = _host_ms(compute, reps)
        out["d2h_ms"] = out["output_KiB"] = None
    out["device_ceiling_img_per_s"] = b / (out["device_compute_ms"] / 1e3)
    done = det.detect_batch_async(packed)
    det._fetch(done)
    out["fetch_host_ms"] = _host_ms(lambda: det._fetch(done), reps)

    out["serial_ms"] = _host_ms(lambda: det.detect_batch(images), reps)
    out["serial_img_per_s"] = b / (out["serial_ms"] / 1e3)
    out["pipelined"] = {}
    for depth in depths:
        q = collections.deque()
        t0 = time.perf_counter()
        for _ in range(iters):
            q.append(det.detect_batch_async(images))
            if len(q) > depth:
                det._fetch(q.popleft())
        while q:
            det._fetch(q.popleft())
        dt = time.perf_counter() - t0
        out["pipelined"][depth] = {"ms_per_batch": 1e3 * dt / iters, "img_per_s": iters * b / dt}
    return out


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES, hw: tuple = (768, 1024)) -> dict:
    """The CLI; `stage_sizes` and `hw` are the published ResNet-101 and the
    768x1024 canvas, only tests shrink them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.utils.instruments import build_detector, card, resolve_device

    dev = resolve_device(args.device)
    det = build_detector(dev, transfer="rgb", stage_sizes=stage_sizes)
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (*hw, 3), dtype=np.uint8) for _ in range(args.batch)]
    r = decompose(det, images, reps=args.reps)
    r["card"] = card(dev)
    fmt = lambda v: "not measured" if v is None else f"{v:.2f}"  # noqa: E731
    print(f"host prep: {r['host_prep_ms']:.2f} ms/batch ({r['canvas_MiB']:.1f} MiB)")
    print(f"H2D: {fmt(r['h2d_ms'])} ms/batch -> {fmt(r['h2d_MiBps'])} MiB/s (CUDA events)")
    print(f"device compute (resident input): {r['device_compute_ms']:.2f} ms/batch -> "
          f"{r['device_ceiling_img_per_s']:.1f} img/s ceiling")
    print(f"fetch: copy back {fmt(r['d2h_ms'])} ms ({fmt(r['output_KiB'])} KiB), host "
          f"{r['fetch_host_ms']:.3f} ms")
    print(f"e2e serial detect_batch: {r['serial_ms']:.2f} ms/batch -> {r['serial_img_per_s']:.1f} img/s")
    for depth, p in r["pipelined"].items():
        print(f"pipelined depth={depth}: {p['ms_per_batch']:.2f} ms/batch -> {p['img_per_s']:.1f} img/s")
    print(f"({r['card']})")
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()

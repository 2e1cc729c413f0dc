"""Serving latency SLO benchmark: p50/p95/p99 against offered load.

    python -m tinyfaces_tpu_torch.tools.serving_bench [--loads 4,8,12,16] [--duration 20]
        [--max-batch 16] [--max-delay-ms 25] [--transfer yuv420] [--device cuda] [--out F]

Port of tools/serving_bench.py. It drives `serving.DetectionService` (bf16
ResNet-101 with seeded weights, `EvalConfig()` defaults) with an open-loop
Poisson arrival process: arrivals do not slow down when the service lags,
so queueing delay shows in the tail. The service's power-of-two batch
ladder is warmed first, so no measurement meets a first call. Each load
level prints one JSON line {"offered_load", "achieved", "n", "p50_ms",
"p95_ms", "p99_ms", "max_ms", ...}, latency from submit to result.

The wire is `yuv420` by default, as in the JAX tool (the host converts each
batch's canvas to planar YCbCr 4:2:0); `rgb`, `jpegdct` and `jpegdct4` (JPEG
files, quality 90, 4:2:0) are the other choices.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Sequence

import numpy as np

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES


def run_level(service, inputs, offered_load, duration_s, seed=0):
    """Open-loop: submit at Poisson arrivals of rate `offered_load`/s for
    `duration_s`; measure submit->result latency per request. The same
    arrival schedule as the JAX tool's for the same seed and duration."""
    rng = np.random.default_rng(seed)
    lat: list[float] = []
    lock = threading.Lock()
    futures = []

    t_start = time.monotonic()
    t_next = t_start
    i = 0
    while t_next - t_start < duration_s:
        now = time.monotonic()
        if now < t_next:
            time.sleep(t_next - now)
        t_sub = time.monotonic()
        fut = service.submit(inputs[i % len(inputs)])

        def _done(f, t0=t_sub):
            with lock:
                lat.append(time.monotonic() - t0)

        fut.add_done_callback(_done)
        futures.append(fut)
        t_next += rng.exponential(1.0 / offered_load)
        i += 1

    for f in futures:
        f.result()
    wall = time.monotonic() - t_start
    lat_ms = np.sort(np.array(lat)) * 1e3
    return {
        "offered_load": offered_load,
        "achieved": round(len(lat) / wall, 2),
        "n": len(lat),
        "p50_ms": round(float(np.percentile(lat_ms, 50)), 1),
        "p95_ms": round(float(np.percentile(lat_ms, 95)), 1),
        "p99_ms": round(float(np.percentile(lat_ms, 99)), 1),
        "max_ms": round(float(lat_ms[-1]), 1),
    }


def warm_ladder(service, inputs, max_batch: int) -> None:
    """Two groups of every power-of-two size up to max_batch (on a GPU a
    batch shape's first call runs eagerly and its second captures)."""
    n = 1
    while n <= max_batch:
        for _ in range(2):
            for f in [service.submit(inputs[i % len(inputs)]) for i in range(n)]:
                f.result()
        n *= 2


def serve(detector, inputs: Sequence, loads: Sequence[float], duration_s: float,
          max_batch: int = 16, max_delay_ms: float = 25.0, card_name: str = "") -> list:
    """A DetectionService over `detector`: the ladder warmed, then one
    run_level row per load, printed as it is measured."""
    from tinyfaces_tpu_torch.serving import DetectionService

    service = DetectionService(detector, max_batch=max_batch, max_delay_ms=max_delay_ms)
    try:
        warm_ladder(service, inputs, max_batch)
        rows = []
        for load in loads:
            row = run_level(service, inputs, load, duration_s)
            row.update(max_batch=max_batch, max_delay_ms=max_delay_ms,
                       transfer=detector.transfer, card=card_name)
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        service.close()
    return rows


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES) -> list:
    """The CLI; `stage_sizes` is the published ResNet-101, only tests
    shrink it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--loads", default="4,8,12,16", help="offered loads (img/s), comma-separated")
    ap.add_argument("--duration", type=float, default=20.0, help="seconds per load level")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-delay-ms", type=float, default=25.0)
    ap.add_argument("--transfer", default="yuv420")
    ap.add_argument("--size", default="768x1024")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.bench import natural_images
    from tinyfaces_tpu_torch.utils.instruments import (PYRAMID_WIRES, build_detector, card,
                                                       check_transfer, pyramid_inputs,
                                                       resolve_device)

    check_transfer(args.transfer, PYRAMID_WIRES)
    dev = resolve_device(args.device)
    h, w = (int(v) for v in args.size.lower().split("x"))
    inputs = pyramid_inputs(args.transfer, natural_images(8, h, w))
    detector = build_detector(dev, transfer=args.transfer, stage_sizes=stage_sizes)
    name = card(dev)
    print(f"# serving {args.transfer} {h}x{w} on {name}", flush=True)
    rows = serve(detector, inputs, [float(v) for v in args.loads.split(",")], args.duration,
                 args.max_batch, args.max_delay_ms, name)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()

"""Per-kernel device profile of the fused pyramid (torch.profiler).

    python -m tinyfaces_tpu_torch.tools.device_profile [--batch 32] [--transfer jpegdct]
        [--iters 3] [--top 30] [--eager] [--device cuda] [--out-dir build/instruments/device_profile]
    python -m tinyfaces_tpu_torch.tools.device_profile --parse-only DIR [--iters 3] [--batch 32]

Port of tools/device_profile.py. After a warm-up batch, `torch.profiler`
(CPU and CUDA activities) records `--iters` batches of distinct inputs,
each packed on the host beforehand and then uploaded, run and fetched in
turn, inside one annotated window ("device_profile.window") that ends in a
device synchronisation. Each batch replays the pyramid's CUDA graph, as
PyramidDetector runs it on a GPU; `--eager` profiles the eager path instead
(the detector's `trace` set, as for a CUDA-event split). The Chrome trace
goes to `--out-dir`; the analysis reads it back (so `--parse-only DIR`
re-reads one):

* the CUDA kernels ranked by summed time (`--top`);
* device time per batch (kernels, copies and memsets) and img/s at it;
* the device's busy share of the window (the union of its activity's
  intervals) and its idle share (the rest);
* device launches (kernels, copies, memsets) per batch, and the host's
  launch calls per batch (CUDA runtime and driver calls that launch a
  kernel or a graph or queue a copy or memset): a replayed graph is one;
* the shares of device time by class: convolution, batch norm,
  elementwise (ReLU, adds, casts), layout conversion (NCHW<->NHWC,
  transposes), matmul (cuBLAS: the resize, and convolutions cuDNN hands
  to it), reduction, copies, other.

A trace without a CUDA event fails the tool: it never prints zeros.
"""

from __future__ import annotations

import argparse
import collections
import json
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES

WINDOW = "device_profile.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_API_CATS = ("cuda_runtime", "cuda_driver")
HOST_LAUNCH_WORDS = ("launch", "memcpy", "memset")
# (class, name fragments), first match wins; names lower-cased.
CLASSES = (
    ("layout", ("nchwtonhwc", "nhwctonchw", "transpose", "permute")),
    ("batch_norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "_bn_")),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd")),
    ("matmul", ("gemm", "gemv", "nvjet")),  # cuBLAS; nvjet: its Hopper GEMMs
    ("elementwise", ("elementwise", "clamp", "threshold")),
    ("reduction", ("reduce", "topk", "sort", "scan")),
)


def kernel_class(name: str, cat: str = "kernel") -> str:
    if cat != "kernel":
        return "copy"
    low = name.lower()
    for cls, fragments in CLASSES:
        if any(f in low for f in fragments):
            return cls
    return "other"


def _union_us(intervals: list) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def parse_trace(path: str | Path, iters: int, batch: int, top: int = 30) -> dict:
    """Analysis of a Chrome trace from `record` (or the trace file in a
    directory): see the module docstring. Raises SystemExit when the trace
    holds no CUDA event."""
    path = Path(path)
    if path.is_dir():
        files = sorted(path.glob("*.json"))
        if not files:
            raise SystemExit(f"no trace (*.json) in {path}")
        path = files[-1]
    events = json.loads(path.read_text()).get("traceEvents", [])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not device:
        raise SystemExit(f"{path}: the profiler recorded no CUDA event (no kernel, copy or "
                         f"memset); nothing to report")
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
               and e.get("cat") == "user_annotation"]
    if windows:
        w0, w1 = windows[0]["ts"], windows[0]["ts"] + windows[0]["dur"]
    else:  # a trace from elsewhere: the span of its device activity
        w0 = min(e["ts"] for e in device)
        w1 = max(e["ts"] + e["dur"] for e in device)
    per_kernel: collections.Counter = collections.Counter()
    per_class: collections.Counter = collections.Counter()
    intervals = []
    for e in device:
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        per_kernel[e["name"]] += e["dur"] / 1e3
        per_class[kernel_class(e["name"], e["cat"])] += e["dur"] / 1e3
        intervals.append((a, b))
    host_launches = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") in HOST_API_CATS
                        and w0 <= e["ts"] < w1
                        and any(w in e.get("name", "").lower() for w in HOST_LAUNCH_WORDS))
    total_ms = sum(per_kernel.values())
    window_ms = (w1 - w0) / 1e3
    busy_ms = _union_us(intervals) / 1e3
    per_batch = total_ms / max(1, iters)
    return {
        "trace": str(path), "iters": iters, "batch": batch, "window_ms": window_ms,
        "device_ms": total_ms, "device_ms_per_batch": per_batch,
        "img_per_s_at_device_time": batch / (per_batch / 1e3) if per_batch > 0 else None,
        "busy_share": busy_ms / window_ms, "idle_share": 1.0 - busy_ms / window_ms,
        "class_share": {k: v / total_ms for k, v in per_class.most_common()},
        "top_kernels": [{"name": k, "ms_per_batch": v / max(1, iters), "share": v / total_ms}
                        for k, v in per_kernel.most_common(top)],
        "kernels_distinct": len(per_kernel),
        "launches_per_batch": len(intervals) / max(1, iters),
        "host_launches_per_batch": host_launches / max(1, iters),
    }


def record(det, packed: Sequence, out_dir: str | Path) -> Path:
    """Warm-up: packed[0] twice (on a GPU: the pyramid's first eager run
    and the capture of its graph, unless `det.trace` is set), then one
    profiled window over packed[1:] (each uploaded, run and fetched in
    turn); returns the trace's path."""
    dev = det.devices[0]
    for _ in range(2):
        det._fetch(det.detect_batch_async(packed[0]))
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(dev)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / "trace.json"
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW):
            for p in packed[1:]:
                det._fetch(det.detect_batch_async(p))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(path))
    return path


def profile(det, inputs_for, iters: int, out_dir: str | Path, top: int = 30,
            eager: bool = False) -> dict:
    """Pack iters + 1 distinct batches (inputs_for(seed)), record, parse.
    `eager`: the eager path (det.trace set for the run, then restored)."""
    packed = [det.pack_inputs(inputs_for(i)) for i in range(iters + 1)]
    batch = packed[0].hs.shape[0]
    saved = det.trace
    det.trace = [] if eager else None
    try:
        path = record(det, packed, out_dir)
    finally:
        det.trace = saved
    r = parse_trace(path, iters, batch, top)
    r["path"] = "eager" if eager else "graph"
    return r


def report(r: dict, name: str) -> None:
    print(f"device time {r['device_ms']:.1f} ms over {r['iters']} batches = "
          f"{r['device_ms_per_batch']:.2f} ms/batch{r['batch']} "
          f"({r['img_per_s_at_device_time']:.1f} img/s at device time, "
          f"{r['launches_per_batch']:.0f} device launches and "
          f"{r['host_launches_per_batch']:.0f} host launch calls a batch, "
          f"{r.get('path', 'graph')} path); window "
          f"{r['window_ms']:.1f} ms, device busy {100 * r['busy_share']:.1f}%, idle "
          f"{100 * r['idle_share']:.1f}% ({name})")
    print("by class: " + ", ".join(f"{k} {100 * v:.1f}%" for k, v in r["class_share"].items()))
    print(f"{'ms/batch':>9}  {'%':>5}  kernel")
    for k in r["top_kernels"]:
        print(f"{k['ms_per_batch']:9.3f}  {100 * k['share']:5.1f}  {k['name'][:110]}")


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES, hw: tuple = (768, 1024)) -> dict:
    """The CLI; `stage_sizes` and `hw` are the published ResNet-101 and the
    768x1024 canvas, only tests shrink them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--transfer", default="jpegdct")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--out-dir", default="build/instruments/device_profile")
    ap.add_argument("--parse-only", default="", help="skip execution; re-parse this trace directory")
    ap.add_argument("--eager", action="store_true",
                    help="profile the eager pyramid (trace set) instead of its CUDA graph's replays")
    args = ap.parse_args(argv)
    if args.parse_only:
        r = parse_trace(args.parse_only, args.iters, args.batch, args.top)
        report(r, "re-parsed")
        print(json.dumps(r))
        return r
    from tinyfaces_tpu_torch.bench import natural_images
    from tinyfaces_tpu_torch.utils.instruments import (PYRAMID_WIRES, build_detector, card,
                                                       check_transfer, pyramid_inputs,
                                                       resolve_device)

    check_transfer(args.transfer, PYRAMID_WIRES)
    dev = resolve_device(args.device)
    det = build_detector(dev, transfer=args.transfer, stage_sizes=stage_sizes)

    def inputs_for(seed):
        return pyramid_inputs(args.transfer, natural_images(args.batch, *hw, seed=seed))

    r = profile(det, inputs_for, args.iters, args.out_dir, args.top, eager=args.eager)
    r.update(card=card(dev), transfer=args.transfer)
    report(r, r["card"])
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()

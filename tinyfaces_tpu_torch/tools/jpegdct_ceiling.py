"""Device ceiling of the `jpegdct` (or `jpegdct4`) fused pyramid: its time
with no host decode in the timed region.

    python -m tinyfaces_tpu_torch.tools.jpegdct_ceiling [--mode device|upload] [--batch 32]
        [--iters 12] [--dtype bf16|fp32] [--transfer jpegdct|jpegdct4] [--device cuda]

Port of tools/jpegdct_ceiling.py. The wires of `--iters` batches are
packed beforehand from JPEG files (quality 90, 4:2:0) of bench's natural
images, the batch order rotated per wire so no two are equal.

* `--mode device`: the wires staged on the card. Every dispatch
  reconstructs the canvas (dequantize, inverse DCT, chroma upsample,
  normalize) and runs the pyramid; each result is copied back. Reported:
  the CUDA-event time from the first dispatch to the last copy per batch,
  its reconstruction share, and the host clock over the same loop.
* `--mode upload`: the wires packed in pinned host RAM; the loop uploads,
  dispatches and fetches with 3 batches in flight (bench's loop without
  the host decode), host clock.

`--transfer jpegdct4` packs and reconstructs the bitmap-sparse wire v4
instead of v3.
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


def pack_wires(det, jpegs: Sequence[bytes], iters: int) -> list:
    """`iters` PackedBatch of the files, rotated one place per wire."""
    b = len(jpegs)
    return [det.pack_inputs([jpegs[(i + k) % b] for k in range(b)]) for i in range(iters)]


def run(det, packed: Sequence, mode: str, depth: int = 3) -> dict:
    """Time the pre-packed wires in `mode` (see the module docstring)."""
    replica = det.replicas[0]
    dev = replica.device
    cuda = dev.type == "cuda"
    b, iters = packed[0].hs.shape[0], len(packed)
    scales = tuple(det.ec.scales)
    out = {"mode": mode, "batch": b, "iters": iters,
           "wire_MiB_per_batch": packed[0].host.numel() / 2**20}
    det._fetch(det.detect_batch_async(packed[0]))  # warm-up
    if mode == "upload":
        q = collections.deque()
        t0 = time.perf_counter()
        for p in packed:
            q.append(det.detect_batch_async(p))
            if len(q) > depth:
                det._fetch(q.popleft())
        while q:
            det._fetch(q.popleft())
        dt = (time.perf_counter() - t0) / iters
        out.update(ms_per_batch=1e3 * dt, img_per_s=b / dt, clock="host")
        return out
    if mode != "device":
        raise ValueError(f"unknown mode {mode!r}")

    staged = []
    for p in packed:
        meta = det._level_sizes(p.hs, p.ws, scales)
        staged.append((p.host.to(dev),
                       torch.from_numpy(np.stack([p.hs, p.ws], 1).astype(np.int64)).to(dev),
                       torch.from_numpy(meta).to(dev), p.h0p, p.w0p))
    marks: list = []

    def mark(phase):
        if cuda and phase in ("unpack", "nms"):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            marks.append(event)

    def dispatch(wire, size_hw, level_hw, h0p, w0p):
        with torch.no_grad():
            return det._fused_pyramid(replica, wire, size_hw, level_hw, scales=scales, h0p=h0p,
                                      w0p=w0p, prob_thresh=float(det.ec.prob_thresh),
                                      nms_thresh=float(det.ec.nms_thresh), mark=mark)

    # Every dispatch queued before any result is read; each result copied
    # back, as _fetch's copy, behind the last.
    starts = []
    t0 = time.perf_counter()
    results = []
    for s in staged:
        if cuda:
            starts.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
        results.append(dispatch(*s))
    hosts = [r.to("cpu", non_blocking=cuda) for r in results]
    if cuda:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
    host_dt = (time.perf_counter() - t0) / iters
    out.update(host_ms_per_batch=1e3 * host_dt, host_img_per_s=b / host_dt,
               detections_per_image=float(np.mean([float(h[..., 5].sum()) / b for h in hosts])))
    if cuda:
        dev_ms = starts[0].elapsed_time(end) / iters
        # marks: (after unpack, after nms) per dispatch
        unpack = [s.elapsed_time(u) for s, u in zip(starts, marks[0::2])]
        out.update(ms_per_batch=dev_ms, img_per_s=b / (dev_ms / 1e3), clock="cuda events",
                   reconstruction_ms=float(np.median(unpack)),
                   reconstruction_share=float(np.median(unpack)) / dev_ms)
    else:
        out.update(ms_per_batch=1e3 * host_dt, img_per_s=b / host_dt, clock="host")
    return out


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES, hw: tuple = (768, 1024)) -> dict:
    """The CLI; `stage_sizes` and `hw` are the published ResNet-101 and the
    768x1024 canvas, only tests shrink them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--mode", choices=["device", "upload"], default="device")
    ap.add_argument("--transfer", default="jpegdct", choices=("jpegdct", "jpegdct4"),
                    help="wire format: v3 zigzag-dense or v4 bitmap-sparse")
    ap.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.bench import natural_images
    from tinyfaces_tpu_torch.utils.instruments import build_detector, card, jpeg_bytes, resolve_device

    dev = resolve_device(args.device)
    if args.dtype == "fp32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    det = build_detector(dev, transfer=args.transfer, stage_sizes=stage_sizes,
                         dtype=torch.bfloat16 if args.dtype == "bf16" else None)
    packed = pack_wires(det, jpeg_bytes(natural_images(args.batch, *hw)), args.iters)
    r = run(det, packed, args.mode)
    r.update(card=card(dev), dtype=args.dtype, transfer=args.transfer)
    recon = (f", reconstruction {r['reconstruction_ms']:.2f} ms "
             f"({100 * r['reconstruction_share']:.1f}%)" if "reconstruction_ms" in r else "")
    label = "device time" if args.mode == "device" else "upload+dispatch+fetch time"
    print(f"{args.transfer} fused pyramid {args.dtype} {label}: {r['ms_per_batch']:.2f} ms/batch{r['batch']} "
          f"= {r['img_per_s']:.2f} img/s ({r['iters']} distinct wires of "
          f"{r['wire_MiB_per_batch']:.2f} MiB, {r['clock']}){recon} ({r['card']})")
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()

"""Model evaluation CLI of the port — the surface of evaluate_model.py (and of
the reference evaluate_model.py:16-31):

    python -m tinyfaces_tpu_torch.evaluate_model ANNOTATIONS \\
        --dataset-root DIR --split val [--checkpoint CKPT] [--device cuda]

Runs the multi-scale pyramid detector over the val/test split and writes
WIDER-format result files (<results_dir>/<event>/<img>.txt), to be graded
by `python -m tinyfaces_tpu_torch.wider_eval`. `--transfer` defaults to
`jpegdct`, as in the JAX CLI: worker threads read each JPEG's bytes, the
pack stage entropy-decodes them in C++ and the device reconstructs the
pixels; `rgb` decodes the images with PIL on the host and uploads the uint8
canvas. `--resample pil` resizes every level with the reference's uint8 PIL
bilinear on the device (ops/pilresize.py) and needs `--transfer rgb`.
`yuv420` and `jpegdct4` exit naming ROADMAP item 15, and
`--data-parallel`/`--shard`/`--coordinator-address` item 13.
`--device` (default cuda) is the port's own flag; nothing falls back to
the CPU when there is no GPU.
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor

import torch

from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.data import get_dataloader
from tinyfaces_tpu_torch.data.jpegdct import input_dims
from tinyfaces_tpu_torch.evaluation import PyramidDetector, _round_up, get_model, write_results

# Device-memory guard for the fused pyramid: the 2x level dominates
# activation memory, so the per-bucket batch is capped by a pixel budget —
# eval_batch images at the 768x1024-class bucket, proportionally fewer for
# larger buckets, always >= 1.
BUDGET_PX_PER_EVAL_IMAGE = 768 * 1024


def bucket_batch_for(bucket: tuple[int, int], eval_batch: int, mesh_n: int = 1) -> int:
    """Device batch size used for a padded (h0p, w0p) bucket."""
    budget_px = eval_batch * BUDGET_PX_PER_EVAL_IMAGE
    n = max(1, min(eval_batch, budget_px // (bucket[0] * bucket[1])))
    return max(mesh_n, n // mesh_n * mesh_n)


def bucket_plan(sizes, eval_batch: int, mesh_n: int = 1) -> dict:
    """{(h0p, w0p): device_batch} over an iterable of (h, w) image sizes."""
    plan = {}
    for h, w in sizes:
        b = (_round_up(h), _round_up(w))
        plan[b] = bucket_batch_for(b, eval_batch, mesh_n)
    return plan


def arguments(argv=None):
    parser = argparse.ArgumentParser("Model Evaluator")
    parser.add_argument("dataset")
    parser.add_argument("--split", default="val")
    parser.add_argument("--dataset-root")
    parser.add_argument("--checkpoint", help="The path to the model checkpoint", default="")
    parser.add_argument("--prob_thresh", type=float, default=0.03)
    parser.add_argument("--nms_thresh", type=float, default=0.3)
    parser.add_argument("--workers", default=8, type=int)
    parser.add_argument("--batch_size", default=1, type=int)
    parser.add_argument("--results_dir", default=None)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--arch", default="resnet101", choices=("resnet101", "resnet50"),
                        help="backbone (reference model.py:13 base_model knob)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 activations with fp32 parameters, fp32 decode and NMS "
                             "(the default; mutually exclusive with --fp32)")
    parser.add_argument("--fp32", action="store_true",
                        help="full fp32 inference, TF32 off (reference-exact precision)")
    parser.add_argument("--eval-batch", type=int, default=32,
                        help="device batch per bucket (1 = per-image)")
    parser.add_argument("--host-resize", action="store_true",
                        help="PIL per-scale resize (reference resampling, one forward per "
                             "scale — slow)")
    parser.add_argument("--resample", default="linear", choices=("linear", "pil"),
                        help="fused-path level resampling: linear (antialiased, on the "
                             "normalized canvas) or pil (the reference's uint8 PIL bilinear, "
                             "byte-exact; needs --transfer rgb)")
    parser.add_argument("--template-pruning", default="reference",
                        choices=("reference", "natural"),
                        help="per-scale template pruning: reference (default) reproduces "
                             "models/utils.py:15-44 incl. its dead branch; natural enables "
                             "the type-B templates at upsampled scales")
    parser.add_argument("--transfer", default="jpegdct",
                        choices=("rgb", "yuv420", "jpegdct", "jpegdct4"),
                        help="fused-path wire format. jpegdct (the default) ships the JPEG "
                             "files' entropy-decoded DCT coefficients (~0.7 B/px) and decodes "
                             "on the GPU; rgb decodes with PIL on the host and uploads the "
                             "uint8 canvas; yuv420 and jpegdct4 are not ported (ROADMAP "
                             "item 15)")
    parser.add_argument("--data-parallel", action="store_true",
                        help="not ported (ROADMAP item 13)")
    parser.add_argument("--coordinator-address", default="",
                        help="not ported (ROADMAP item 13); slicing needs no coordinator")
    parser.add_argument("--num-processes", default=0, type=int,
                        help="total eval processes (0 = single process); each detects "
                             "images rank::world")
    parser.add_argument("--process-id", default=0, type=int)
    parser.add_argument("--shard", default="batch", choices=("batch", "spatial", "auto"),
                        help="mesh sharding mode; not ported (ROADMAP items 13, 15)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    return parser.parse_args(argv)


def run(detector, dataset, prob_thresh, nms_thresh, split, results_dir=None,
        debug=False, eval_batch=32, host_resize=False, workers=8,
        inflight=3, rank=0, world=1):
    """Evaluate the split with a three-stage pipeline: worker threads decode
    images (the reference's DataLoader(num_workers=8)) or, on the jpegdct
    wire, only read the JPEG bytes (`dataset.get_dct`), the main thread
    groups images sharing a padded bucket into fixed-size device batches,
    and up to `inflight` batches are in flight (detect_batch_async) so host
    decode, packing and upload overlap device compute. `host_resize` takes
    the per-image PIL-resize path instead.

    `rank`/`world`: this process detects images `rank::world` only; the
    per-image result files are disjoint, so all ranks may share one
    results_dir. The phase summary goes to stderr and `run.last_phases`."""
    indices = list(range(len(dataset)))[rank::world]
    n = len(indices)
    done = 0
    dets = None
    run.last_phases = None
    ph = {"decode_wait": 0.0, "pack": 0.0, "dispatch": 0.0, "result_wait": 0.0,
          "fetch_d2h": 0.0, "write": 0.0, "fetches": 0, "first_fetch": 0.0,
          "t_first_settled": 0.0, "done_at_first": 0}
    t_sweep = time.perf_counter()

    dct = detector.transfer == "jpegdct"
    if dct and host_resize:
        raise ValueError("--host-resize needs decoded pixels; use --transfer rgb with it")
    # jpegdct: the workers entropy-decode only files the fused C++ pack
    # cannot take; pixels never exist on the host
    fetch = dataset.get_dct if dct else dataset.__getitem__

    if host_resize or eval_batch <= 1:
        for i in indices:
            image, img_path = fetch(i)
            if host_resize:
                dets = detector.detect(image, prob_thresh, nms_thresh, host_resize=True)
            else:
                dets = detector.detect_batch([image], prob_thresh, nms_thresh)[0]
            write_results(dets, img_path, split, results_dir)
            done += 1
            if done % 25 == 0 or done == n:
                print(f"[{done}/{n}] {img_path}: {dets.shape[0]} detections")
            if debug and done >= 5:
                break
        return dets

    groups: dict = defaultdict(list)
    pending: deque = deque()

    def settle(entry):
        nonlocal done, dets
        items, submitted = entry
        t0 = time.perf_counter()
        async_out = submitted.result()
        t1 = time.perf_counter()
        results = detector._fetch(async_out)
        t2 = time.perf_counter()
        ph["result_wait"] += t1 - t0
        ph["fetch_d2h"] += t2 - t1
        for (_, img_path), d in zip(items, results):
            write_results(d, img_path, split, results_dir)
            dets = d
            done += 1
            if done % 25 == 0 or done == n:
                print(f"[{done}/{n}] {img_path}: {d.shape[0]} detections")
        ph["write"] += time.perf_counter() - t2
        ph["fetches"] += 1
        if ph["fetches"] == 1:
            ph["first_fetch"] = t2 - t1
            ph["t_first_settled"] = time.perf_counter() - t_sweep
            ph["done_at_first"] = done

    # Two single-worker host stages: pack (canvas into pinned memory) and
    # dispatch (upload + queueing the pyramid); one dispatch worker keeps
    # the batches in order.
    pack_pool = ThreadPoolExecutor(1)
    submit_pool = ThreadPoolExecutor(1)

    def timed_pack(imgs):
        t0 = time.perf_counter()
        out = detector.pack_inputs(imgs)
        ph["pack"] += time.perf_counter() - t0
        return out

    def timed_dispatch(p):
        packed = p.result()
        t0 = time.perf_counter()
        out = detector.detect_batch_async(packed, prob_thresh, nms_thresh)
        ph["dispatch"] += time.perf_counter() - t0
        return out

    def flush(bucket):
        items = groups.pop(bucket)
        imgs = [im for im, _ in items]
        # pad the group to the bucket's fixed batch size; surplus outputs
        # are discarded
        imgs += [imgs[-1]] * (bucket_batch_for(bucket, eval_batch) - len(imgs))
        packed = pack_pool.submit(timed_pack, imgs)
        pending.append((items, submit_pool.submit(timed_dispatch, packed)))
        while len(pending) > inflight:
            settle(pending.popleft())

    limit = min(5, n) if debug else n
    # Decode ahead in worker threads (PIL's decode drops the GIL) through a
    # bounded window of futures.
    window = max(2, workers) * 3
    with ThreadPoolExecutor(max(1, workers)) as pool:
        futs: deque = deque()
        nxt = 0
        while futs or nxt < limit:
            while nxt < limit and len(futs) < window:
                futs.append(pool.submit(fetch, indices[nxt]))
                nxt += 1
            t0 = time.perf_counter()
            image, img_path = futs.popleft().result()
            ph["decode_wait"] += time.perf_counter() - t0
            h, w = input_dims(image)
            bucket = (_round_up(h), _round_up(w))
            groups[bucket].append((image, img_path))
            if len(groups[bucket]) >= bucket_batch_for(bucket, eval_batch):
                flush(bucket)
        for bucket in list(groups):
            flush(bucket)
        while pending:
            settle(pending.popleft())
    pack_pool.shutdown(wait=True)
    submit_pool.shutdown(wait=True)
    wall = time.perf_counter() - t_sweep
    # Steady-state rate: everything after the first batch settles (the
    # first absorbs cuDNN's first-call set-up).
    steady_n = done - ph["done_at_first"]
    steady_wall = wall - ph["t_first_settled"]
    steady = steady_n / steady_wall if steady_n > 0 and steady_wall > 1e-3 else None
    run.last_phases = {**ph, "wall": wall, "done": done,
                       "images_per_sec": done / wall if wall > 0 else None,
                       "images_per_sec_steady": steady}
    print(
        f"# sweep phases (wall {wall:.1f}s, {done} imgs, {done / wall:.1f} img/s"
        + (f", steady-state {steady:.1f} img/s after the first settle" if steady is not None else "")
        + f"): main-thread decode_wait {ph['decode_wait']:.1f}s, result_wait "
        f"{ph['result_wait']:.1f}s, fetch_d2h {ph['fetch_d2h']:.1f}s (first fetch "
        f"{ph['first_fetch']:.1f}s), write {ph['write']:.1f}s; worker-thread pack "
        f"{ph['pack']:.1f}s, dispatch {ph['dispatch']:.1f}s",
        file=sys.stderr,
    )
    return dets


def _refusal(args) -> str | None:
    """Why these flags cannot run, or None."""
    if args.transfer not in ("rgb", "jpegdct"):
        return f"--transfer {args.transfer} is not ported (ROADMAP item 15); use jpegdct or rgb"
    if args.resample == "pil" and args.transfer != "rgb":
        return ("resample='pil' reproduces the reference's uint8-domain resampling and needs "
                "exact pixels on device — use transfer='rgb' (lossy wires defeat the parity point)")
    if args.data_parallel or args.shard != "batch" or args.coordinator_address:
        return "--data-parallel/--shard/--coordinator-address are not ported yet (ROADMAP item 13)"
    return None


def main(argv=None):
    args = arguments(argv)
    if args.bf16 and args.fp32:
        raise SystemExit("--bf16 and --fp32 are mutually exclusive")
    problem = _refusal(args)
    if problem:
        raise SystemExit(problem)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    if args.fp32:  # fp32 means fp32: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        print("# precision: bf16 (the default; pass --fp32 for reference-exact precision)",
              file=sys.stderr)

    cfg = DetectorConfig()
    dataset, templates = get_dataloader(args.dataset, args, train=False, split=args.split, cfg=cfg)
    model = get_model(args.checkpoint, num_templates=templates.shape[0], dtype=dtype,
                      arch=args.arch, device=args.device)
    detector = PyramidDetector(model, templates, cfg=cfg,
                               ec=EvalConfig(resample=args.resample,
                                             template_pruning=args.template_pruning),
                               device=args.device, transfer=args.transfer)
    run(detector, dataset, args.prob_thresh, args.nms_thresh, args.split,
        results_dir=args.results_dir, debug=args.debug, eval_batch=args.eval_batch,
        host_resize=args.host_resize, workers=args.workers, rank=args.process_id,
        world=max(1, args.num_processes))


if __name__ == "__main__":
    main()

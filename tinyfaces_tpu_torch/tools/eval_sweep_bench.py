"""Eval-sweep throughput: pipelined against sync-batch against per-image.

    python -m tinyfaces_tpu_torch.tools.eval_sweep_bench [--n 200] [--transfer jpegdct]
        [--eval-batch 32] [--device cuda] [--root build/instruments/eval_sweep_bench]

Port of tools/eval_sweep_bench.py. It writes a synthetic WIDER val tree of
`--n` JPEG files (quality 90) in four sizes — 768x1024, 680x1024, 768x1024,
576x768 in turn, so bucketing has work — with natural spectral statistics,
then times `evaluate_model.run` over it three ways, each after two warm
runs over its first 8 images (on a GPU a bucket's first batch runs eagerly
and its second captures the pyramid's graph):

  pipelined   bucket batches of --eval-batch, 8 decode workers, 3 in flight;
  sync-batch  bucket batches, 1 worker, nothing in flight;
  per-image   eval_batch=1 (the reference's serial path).

Prints img/s for each and the ratios. The model is bf16 ResNet-101 with
seeded weights; `--transfer` jpegdct (the CLI's default), jpegdct4, rgb or
yuv420.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import shutil
import time
from pathlib import Path
from typing import Sequence

import numpy as np

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES

SIZES = ((768, 1024), (680, 1024), (768, 1024), (576, 768))


def build_tree(root: Path, n: int, seed: int = 0, sizes: Sequence[tuple] = SIZES) -> Path:
    """`n` JPEG files under root/WIDER_val/images/0--Bench and the WIDER
    annotation file root/val.txt (one face each); returns its path."""
    from tinyfaces_tpu_torch.utils.instruments import jpeg_bytes

    rng = np.random.default_rng(seed)
    d = root / "WIDER_val" / "images" / "0--Bench"
    d.mkdir(parents=True, exist_ok=True)
    ann = []
    for i in range(n):
        h, w = sizes[i % len(sizes)]
        yy, xx = np.mgrid[0:h, 0:w]
        base = 128 + 60 * np.sin(xx / 97.0) + 40 * np.cos(yy / 61.0)
        tex = np.kron(rng.normal(0, 18, (h // 8, w // 8, 3)), np.ones((8, 8, 1)))
        img = np.clip(base[..., None] + tex, 0, 255).astype(np.uint8)
        img[100:180, 100:180] = 255
        (d / f"im{i}.jpg").write_bytes(jpeg_bytes([img], quality=90, subsampling=-1)[0])
        ann += [f"0--Bench/im{i}.jpg", "1", "100 100 80 80 0 0 0 0 0 0"]
    gt = root / "val.txt"
    gt.write_text("\n".join(ann) + "\n")
    return gt


class _Prefix:
    """The first `n` images of a dataset (the warm run's)."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.dataset[i]

    def get_dct(self, i):
        return self.dataset.get_dct(i)


def sweep(det, dataset, root: Path, eval_batch: int = 32, warm_n: int = 8) -> dict:
    """img/s of evaluate_model.run in the three modes, and their ratios."""
    from tinyfaces_tpu_torch import evaluate_model

    n = len(dataset)
    modes = {"pipelined": dict(eval_batch=eval_batch, workers=8, inflight=3),
             "sync-batch": dict(eval_batch=eval_batch, workers=1, inflight=0),
             "per-image": dict(eval_batch=1)}
    out = {"n": n, "eval_batch": eval_batch}
    for name, kw in modes.items():
        with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
            for _ in range(2):  # on a GPU: each bucket's eager first call, then its capture
                evaluate_model.run(det, _Prefix(dataset, min(warm_n, n)), 0.03, 0.3, "val",
                                   results_dir=root / "warm", **kw)
            t0 = time.perf_counter()
            evaluate_model.run(det, dataset, 0.03, 0.3, "val", results_dir=root / name, **kw)
            dt = time.perf_counter() - t0
        out[name] = {"img_per_s": n / dt, "seconds": dt}
    out["pipelined_vs_sync"] = out["pipelined"]["img_per_s"] / out["sync-batch"]["img_per_s"]
    out["pipelined_vs_per_image"] = out["pipelined"]["img_per_s"] / out["per-image"]["img_per_s"]
    return out


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES,
         sizes: Sequence[tuple] = SIZES) -> dict:
    """The CLI; `stage_sizes` and `sizes` are the published ResNet-101 and
    the four WIDER-like sizes, only tests shrink them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--transfer", default="jpegdct")
    ap.add_argument("--eval-batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--root", default="build/instruments/eval_sweep_bench")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.data import load_templates
    from tinyfaces_tpu_torch.data.wider_face import WIDERFace
    from tinyfaces_tpu_torch.utils.instruments import (PYRAMID_WIRES, build_detector, card,
                                                       check_transfer, resolve_device)

    check_transfer(args.transfer, PYRAMID_WIRES)
    dev = resolve_device(args.device)
    root = Path(args.root)
    if root.exists():
        shutil.rmtree(root)
    gt = build_tree(root, args.n, sizes=sizes)
    det = build_detector(dev, transfer=args.transfer, stage_sizes=stage_sizes)
    dataset = WIDERFace(gt, load_templates(), dataset_root=root, split="val")
    r = sweep(det, dataset, root, args.eval_batch)
    r.update(card=card(dev), transfer=args.transfer)
    for mode in ("pipelined", "sync-batch", "per-image"):
        print(f"{mode}: {r[mode]['img_per_s']:.2f} img/s ({r[mode]['seconds']:.1f} s)")
    print(f"pipelined vs sync-batch: {r['pipelined_vs_sync']:.2f}x; vs per-image: "
          f"{r['pipelined_vs_per_image']:.2f}x ({r['card']}, {args.transfer}, n={args.n})")
    import json

    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()

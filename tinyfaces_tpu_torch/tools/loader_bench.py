"""Host data pipeline: the Python augmentation against the C++ engine.

    python -m tinyfaces_tpu_torch.tools.loader_bench [--images 64] [--device cuda]
        [--root build/instruments/loader_bench]

Port of tools/loader_bench.py. It writes a synthetic WIDER train tree of
JPEG files (uniform noise, 600-1000 x 700-1100 px, 3-29 faces each) and
runs one epoch of batch 12 on 8 workers through `PrefetchLoader` (PIL
decode and NumPy augmentation in worker threads) and
`NativePrefetchLoader` (decode in threads, crop/paste/flip in the C++
engine), each batch uploaded to `--device`. Prints samples/s of each and
the native speedup.
"""

from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

import numpy as np


def build_tree(root: Path, n_imgs: int, seed: int = 0, hw_range=((600, 1000), (700, 1100))) -> Path:
    """`n_imgs` JPEG files and their annotation file root/gt.txt."""
    from tinyfaces_tpu_torch.utils.instruments import jpeg_bytes

    rng = np.random.default_rng(seed)
    d = root / "WIDER_train" / "images" / "0--Ev"
    d.mkdir(parents=True)
    lines = []
    for i in range(n_imgs):
        h, w = int(rng.integers(*hw_range[0])), int(rng.integers(*hw_range[1]))
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        (d / f"im{i}.jpg").write_bytes(jpeg_bytes([img], quality=90, subsampling=-1)[0])
        rows = []
        for _ in range(int(rng.integers(3, 30))):
            bw, bh = int(rng.integers(10, min(120, w // 2))), int(rng.integers(10, min(120, h // 2)))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            rows.append(f"{x} {y} {bw} {bh} 0 0 0 0 0 0")
        lines += [f"0--Ev/im{i}.jpg", str(len(rows))] + rows
    ann = root / "gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    return ann


def measure(dataset, device, batch_size: int = 12, workers: int = 8) -> dict:
    """samples/s of one epoch through each loader, and the native speedup."""
    import torch

    from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader, PrefetchLoader

    if len(dataset) < batch_size:
        raise SystemExit(f"{len(dataset)} images make no batch of {batch_size}")
    out = {}
    for name, cls in (("python", PrefetchLoader), ("native", NativePrefetchLoader)):
        loader = cls(dataset, batch_size=batch_size, device=device, workers=workers, seed=0)
        t0 = time.perf_counter()
        n = 0
        for batch in loader:
            n += batch["image"].shape[0]
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        out[name] = {"samples_per_s": n / dt, "samples": n, "seconds": dt}
    out["native_speedup"] = out["native"]["samples_per_s"] / out["python"]["samples_per_s"]
    return out


def main(argv=None, *, hw_range=((600, 1000), (700, 1100))) -> dict:
    """The CLI; `hw_range` is the JAX tool's image sizes, only tests
    shrink it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    ap.add_argument("--root", default="build/instruments/loader_bench")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.config import DetectorConfig
    from tinyfaces_tpu_torch.data.wider_face import WIDERFace
    from tinyfaces_tpu_torch.utils.instruments import card, resolve_device

    dev = resolve_device(args.device)
    root = Path(args.root)
    if root.exists():
        shutil.rmtree(root)
    ann = build_tree(root, args.images, hw_range=hw_range)
    ds = WIDERFace(ann, np.zeros((25, 5)), cfg=DetectorConfig(), dataset_root=root, split="train")
    r = measure(ds, dev)
    r["card"] = card(dev)
    for name in ("python", "native"):
        print(f"{name} loader: {r[name]['samples_per_s']:.1f} samples/sec "
              f"({r[name]['seconds']:.2f}s for {r[name]['samples']})")
    print(f"native speedup: {r['native_speedup']:.2f}x ({r['card']})")
    print(json.dumps(r))
    return r


if __name__ == "__main__":
    main()

"""Wire-size statistics: B/px of the `jpegdct` (v3) and `jpegdct4` (v4)
wires against JPEG quality and content.

    python -m tinyfaces_tpu_torch.tools.wire_stats [--h 768] [--w 1024] [--n 8] [--json]
        [--psnr] [--device cuda]

Port of tools/wire_stats.py. The spread across JPEG qualities (q75/85/90/
95) and four content classes — smooth gradients, bench's "natural",
high-frequency texture (the worst case) and hard-edged graphics — so the
headline wire size is not a friendly input's. Host-only statistics; the
matching worst-case throughput is `BENCH_QUALITY=95 BENCH_CONTENT=texture
python -m tinyfaces_tpu_torch.bench`.

Both wires are fixed-capacity (their bytes depend on the canvas only);
content shows as truncation, the share of nonzero AC coefficients past the
zigzag cutoff (v3 and v4) or past v4's image-wide value-stream budget.
`--psnr` reconstructs one image per cell on `--device` through
`ops/jpeg.dct_batch_to_normalized` / `dct4_batch_to_normalized` and
reports its PSNR against PIL's full decode of the same bytes.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

QUALITIES = (75, 85, 90, 95)
KINDS = ("smooth", "natural", "texture", "graphics")


def content_images(kind: str, n: int, h: int, w: int, seed: int = 0):
    """Content classes spanning the JPEG-statistics range; the same arrays
    as tools/wire_stats.py's for the same arguments.

    smooth:  gradients only — near-best case (most AC coefficients zero).
    natural: bench's generator (photo-like luma/chroma spectra).
    texture: per-pixel full-spectrum luma noise — worst realistic case
             (foliage/gravel/sensor noise push every AC band).
    graphics: hard edges + flat fills (screenshots, charts) — ringing
             spreads energy across AC bands along edges.
    """
    rng = np.random.default_rng(seed)
    if kind == "natural":
        from tinyfaces_tpu_torch.bench import natural_images

        return natural_images(n, h, w, seed=seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for _ in range(n):
        if kind == "smooth":
            img = (128 + 60 * np.sin(xx / 97.0 + rng.uniform(0, 6))
                   + 40 * np.cos(yy / 61.0 + rng.uniform(0, 6)))
            img = np.repeat(img[..., None], 3, axis=2) + [10, 0, -10]
        elif kind == "texture":
            base = 128 + 30 * np.sin(xx / 53.0)
            img = (base[..., None]
                   + rng.normal(0, 40, (h, w, 1))      # full-band luma
                   + rng.normal(0, 8, (h, w, 3)))       # chroma grain
        elif kind == "graphics":
            img = np.full((h, w, 3), 240.0)
            for _ in range(40):  # axis-aligned boxes with hard edges
                y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
                y1 = y0 + rng.integers(8, h // 3)
                x1 = x0 + rng.integers(8, w // 3)
                img[y0:y1, x0:x1] = rng.integers(0, 255, 3)
        else:
            raise ValueError(kind)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def measure(imgs, h, w, quality: int) -> dict:
    """JPEG B/px, nonzero AC coefficients, and per wire version (v3, v4) its
    B/px and the share of nonzero AC coefficients it drops."""
    from tinyfaces_tpu_torch.data import jpegdct
    from tinyfaces_tpu_torch.utils.instruments import jpeg_bytes

    jpegs = jpeg_bytes(imgs, quality)
    nonzero_ac = 0
    for data in jpegs:
        dct = jpegdct.parse_jpeg_dct(data)
        for plane in (dct.y, dct.cb, dct.cr):
            if plane is not None:
                nonzero_ac += int(np.count_nonzero(plane[..., 1:]))
    px = len(imgs) * h * w
    row = {"jpeg_Bpx": sum(len(j) for j in jpegs) / px, "nonzero_ac": nonzero_ac}
    for version in (3, 4):
        before = jpegdct.truncation_stats()["truncated_coeffs"]
        wire = jpegdct.pack_dct_batch(jpegs, h, w, wire_version=version)
        dropped = jpegdct.truncation_stats()["truncated_coeffs"] - before
        row[f"v{version}_Bpx"] = jpegdct.wire_bytes(wire) / px
        row[f"v{version}_drop_pct"] = 100.0 * dropped / max(nonzero_ac, 1)
    return row


def wire_psnr(img: np.ndarray, h: int, w: int, quality: int, device="cpu",
              version: int = 3) -> float:
    """PSNR of wire `version`'s reconstruction (float32, on `device`)
    against PIL's full decode of the same JPEG bytes: what truncation costs
    in pixels, the JPEG's own loss aside."""
    import io

    import torch

    from tinyfaces_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
    from tinyfaces_tpu_torch.data import jpegdct
    from tinyfaces_tpu_torch.ops.jpeg import dct4_batch_to_normalized, dct_batch_to_normalized
    from tinyfaces_tpu_torch.utils.instruments import jpeg_bytes

    data = jpeg_bytes([img], quality)[0]  # exits naming PIL without it
    from PIL import Image

    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"), np.float32)
    wire = jpegdct.pack_dct_batch([data], h, w, wire_version=version)
    unpack = dct4_batch_to_normalized if version == 4 else dct_batch_to_normalized
    x = unpack({"_wire": torch.from_numpy(wire["_wire"]).to(device)}, h, w, dtype=torch.float32)
    x = x[0, :img.shape[0], :img.shape[1]].cpu().numpy()
    recon = (x * np.asarray(IMAGENET_STD) + np.asarray(IMAGENET_MEAN)) * 255.0
    mse = float(np.mean((recon - ref) ** 2))
    return 99.0 if mse < 1e-9 else 10.0 * np.log10(255.0**2 / mse)


def table(h: int, w: int, n: int, psnr: bool = False, device="cpu") -> dict:
    out = {}
    for kind in KINDS:
        imgs = content_images(kind, n, h, w)
        for q in QUALITIES:
            row = measure(imgs, h, w, q)
            if psnr:
                for version in (3, 4):
                    row[f"v{version}_psnr_db"] = wire_psnr(imgs[0], h, w, q, device, version)
            out[f"{kind}/q{q}"] = row
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--h", type=int, default=768)
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--n", type=int, default=8, help="images per cell")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--psnr", action="store_true",
                    help="also reconstruct one image per cell and report its PSNR")
    ap.add_argument("--device", default="cuda",
                    help="where --psnr reconstructs (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.utils.instruments import resolve_device

    dev = resolve_device(args.device)
    rows = table(args.h, args.w, args.n, args.psnr, dev)
    if args.json:
        print(json.dumps(rows, indent=1, default=float))
        return rows
    psnr_hdr = f" {'v3psnr':>7} {'v4psnr':>7}" if args.psnr else ""
    print(f"{'content/quality':>16} {'jpegB/px':>9} {'v3B/px':>7} {'v4B/px':>7} {'v3drop%':>8} "
          f"{'v4drop%':>8}{psnr_hdr}")
    for key, row in rows.items():
        psnr = f" {row['v3_psnr_db']:7.1f} {row['v4_psnr_db']:7.1f}" if args.psnr else ""
        print(f"{key:>16} {row['jpeg_Bpx']:9.3f} {row['v3_Bpx']:7.3f} {row['v4_Bpx']:7.3f} "
              f"{row['v3_drop_pct']:8.3f} {row['v4_drop_pct']:8.3f}{psnr}")
    worst = max(rows.items(), key=lambda kv: kv[1]["v4_drop_pct"])
    print(f"\nwire bytes are fixed-capacity (content-independent); worst v4 truncation: "
          f"{worst[0]} drops {worst[1]['v4_drop_pct']:.2f}% of nonzero AC (v3 "
          f"{worst[1]['v3_drop_pct']:.2f}%); yuv420 = 1.5 B/px, rgb = 3.0")
    return rows


if __name__ == "__main__":
    main()

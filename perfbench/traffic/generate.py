"""The generators the mix files parametrise.

* `image_sizes`, `natural_image`, `jpeg_pool`: photos with natural-photo
  spectral statistics (a smooth base, luma-dominant 8x8 texture, weak 16x16
  chroma texture), encoded as baseline 4:2:0 JPEG files, the format WIDER
  images arrive in: by PIL, or by traffic/jpeg.py, which keeps the
  coefficients each file carries for the reference;
* `arrivals`: an open-loop Poisson schedule of a fixed number of requests;
* `wider_tree`: a WIDER-format train tree (JPEG files and the annotation
  file listing each many times) with a heavy tail of faces an image.
"""

from __future__ import annotations

import io
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi]."""
    return np.round(np.linspace(lo, hi, n)).astype(int)


def image_sizes(rng: np.random.Generator, n: int, height: Sequence[int], width: Sequence[int]) -> list:
    """n (h, w) sizes: heights and widths each spread evenly over their
    ranges, paired and ordered by `rng`."""
    hs, ws = spread(*height, n), spread(*width, n)
    return list(zip(rng.permutation(hs).tolist(), rng.permutation(ws).tolist()))


def natural_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 3) uint8 photo-like image."""
    phase = rng.uniform(0, 2 * np.pi, 2)
    base = (128 + 60 * np.sin(np.arange(w, dtype=np.float32) / 97.0 + phase[0])[None, :]
            + 40 * np.cos(np.arange(h, dtype=np.float32) / 61.0 + phase[1])[:, None])
    tex = rng.normal(0, 18, (-(-h // 8), -(-w // 8))).astype(np.float32)
    tex = tex.repeat(8, 0).repeat(8, 1)[:h, :w]
    ctex = rng.normal(0, 5, (-(-h // 16), -(-w // 16), 3)).astype(np.float32)
    ctex = ctex.repeat(16, 0).repeat(16, 1)[:h, :w]
    img = (base + tex)[..., None] + ctex + np.array([12, 0, -12], np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_bytes(image: np.ndarray, quality: int) -> bytes:
    """Baseline JPEG, 4:2:0 chroma, at `quality` (PIL)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "JPEG", quality=quality, subsampling=2)
    return buf.getvalue()


def jpegs(rng: np.random.Generator, sizes: Sequence, quality: int, threads: int = 8,
          exact: bool = False) -> list:
    """A JPEG file of a natural_image of each (h, w), each image drawn from
    its own generator (seeded from `rng`), made on `threads` threads. With
    `exact`, each item is (bytes, coefficients) from traffic/jpeg.py's
    encoder (the eval pools), else PIL's bytes (the train tree, which the
    port's loader decodes with PIL)."""
    from perfbench.traffic import jpeg

    seeds = rng.integers(0, 2**63, len(sizes))

    def one(i):
        h, w = sizes[i]
        image = natural_image(np.random.default_rng(int(seeds[i])), h, w)
        if exact:
            data, co = jpeg.encode(image, quality)
            return data, {k: v.astype(np.int16) if k in ("y", "cb", "cr") else v for k, v in co.items()}
        return jpeg_bytes(image, quality)

    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(one, range(len(sizes))))


def jpeg_pool(rng: np.random.Generator, n: int, height: Sequence[int], width: Sequence[int],
              quality: int) -> list:
    """n (JPEG file, its coefficients) of image_sizes."""
    return jpegs(rng, image_sizes(rng, n, height, width), quality, exact=True)


def arrivals(rng: np.random.Generator, rate: float, seconds: float) -> np.ndarray:
    """Send times (s from the window's start) of round(rate * seconds)
    requests: the gaps are the exponential distribution's quantiles at
    (k + 0.5) / n, so every seed has the same gaps, put in an order drawn
    from `rng` and scaled to end inside the window."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = rng.permutation(gaps)
    times = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return times * min(1.0, seconds * (1 - 0.5 / n) / max(times[-1], 1e-9))


def face_counts(n: int, scale: float, alpha: float) -> np.ndarray:
    """n face counts from a Pareto tail's quantiles at (k + 0.5) / n: most
    images hold a few faces, the last few hundreds."""
    u = (np.arange(n) + 0.5) / n
    return np.maximum(1, np.round(scale * (1.0 - u) ** (-1.0 / alpha))).astype(int)


def wider_tree(rng: np.random.Generator, out: Path, t: dict) -> tuple[Path, dict]:
    """Write t["images"] JPEG files of width t["width"] and heights spread
    over t["height"] into out/WIDER_train/images/, and the annotation file
    listing each t["repeats"] times. Faces an image follow face_counts;
    face heights are log-normal (median t["face_median_px"], clipped to
    t["face_px"]), widths 0.75-0.9 of the height. Returns the annotation's
    path and a summary."""
    n = t["images"]
    heights = rng.permutation(spread(*t["height"], n))
    counts = rng.permutation(face_counts(n, t["faces_scale"], t["faces_alpha"]))
    img_dir = out / "WIDER_train" / "images" / "0--Bench"
    img_dir.mkdir(parents=True, exist_ok=True)
    w = t["width"]
    for i, data in enumerate(jpegs(rng, [(h, w) for h in heights.tolist()], t["quality"])):
        (img_dir / f"bench_{i}.jpg").write_bytes(data)
    rows = []
    for i, (h, k) in enumerate(zip(heights.tolist(), counts.tolist())):
        fh = np.clip(np.exp(rng.normal(math.log(t["face_median_px"]), t["face_sigma"], k)), *t["face_px"])
        fw = np.maximum(1.0, fh * rng.uniform(0.75, 0.9, k))
        x1 = rng.uniform(0, w - fw - 1)
        y1 = rng.uniform(0, h - fh - 1)
        rows.append((f"0--Bench/bench_{i}.jpg",
                     [f"{int(a)} {int(b)} {max(1, int(c))} {max(1, int(d))} 0 0 0 0 0 0"
                      for a, b, c, d in zip(x1, y1, fw, fh)]))
    lines = []
    for _ in range(t["repeats"]):
        for path, boxes in rows:
            lines += [path, str(len(boxes))] + boxes
    ann = out / "wider_face_train_bbx_gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    return ann, {"images": n, "entries": n * t["repeats"], "faces_max": int(counts.max()),
                 "faces_median": float(np.median(counts))}

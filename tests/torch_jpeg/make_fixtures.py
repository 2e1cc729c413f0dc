"""JPEG fixtures of the port's `jpegdct` tests and of chip_smoke.py.

    python tests/torch_jpeg/make_fixtures.py

writes, next to this script, JPEG files of 1/f-spectrum images (the
generator of chip_smoke.py) made with PIL, and `manifest.json` with each
file's (h, w), its kind, and the SHA-256 of the quantized coefficients and
quant tables that the JAX package's decoder (tinyfaces_tpu/data/jpegdct.py)
reads from it: eight baseline 4:2:0 files at WIDER sizes (long side 1024),
one grayscale file, one color file of odd size, and one small progressive
file, whose coefficients the native decoder does not read (it needs PIL's
transcode, so it has no checksum). Needs PIL and the JAX package; the
files it wrote are read where neither is installed.
"""

from __future__ import annotations

import hashlib
import io
import json
import sys
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent
MANIFEST = FIXTURE_DIR / "manifest.json"
# name, (h, w), quality, kind
SPECS = [
    ("wide_768x1024_q75.jpg", (768, 1024), 75, "baseline"),
    ("wide_768x1024_q85.jpg", (768, 1024), 85, "baseline"),
    ("wide_768x1024_q90.jpg", (768, 1024), 90, "baseline"),
    ("wide_683x1024_q80.jpg", (683, 1024), 80, "baseline"),
    ("wide_683x1024_q90.jpg", (683, 1024), 90, "baseline"),
    ("wide_683x1024_q75.jpg", (683, 1024), 75, "baseline"),
    ("tall_1024x683_q85.jpg", (1024, 683), 85, "baseline"),
    ("tall_1024x683_q80.jpg", (1024, 683), 80, "baseline"),
    ("gray_240x320_q85.jpg", (240, 320), 85, "gray"),
    ("odd_197x263_q90.jpg", (197, 263), 90, "baseline"),
    ("progressive_120x160_q85.jpg", (120, 160), 85, "progressive"),
]


def coef_sha256(dct) -> str:
    """SHA-256 of a DCTImage's coefficient planes and quant tables, in the
    order y, cb, cr, qy, qc (absent planes skipped)."""
    h = hashlib.sha256()
    for a in (dct.y, dct.cb, dct.cr, dct.qy, dct.qc):
        if a is not None:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def main() -> None:
    from PIL import Image

    sys.path.insert(0, str(FIXTURE_DIR.parents[1]))
    from chip_smoke import pink_images
    from tinyfaces_tpu.data.jpegdct import parse_jpeg_dct

    rng = np.random.default_rng(20)
    manifest = {}
    for (name, hw, quality, kind), img in zip(SPECS, pink_images(rng, [s[1] for s in SPECS])):
        im = Image.fromarray(img[..., 0] if kind == "gray" else img)
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=quality, subsampling=2, progressive=kind == "progressive")
        data = buf.getvalue()
        (FIXTURE_DIR / name).write_bytes(data)
        entry = {"h": hw[0], "w": hw[1], "kind": kind, "bytes": len(data)}
        if kind != "progressive":
            entry["coef_sha256"] = coef_sha256(parse_jpeg_dct(data))
        manifest[name] = entry
    MANIFEST.write_text(json.dumps(manifest, indent=1) + "\n")


if __name__ == "__main__":
    main()

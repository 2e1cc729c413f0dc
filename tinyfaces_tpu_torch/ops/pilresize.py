"""PIL-bilinear-matched resize of padded canvases (the reference's resampling).

Port of tinyfaces_tpu/ops/pilresize.py. The reference resizes every pyramid
level with PIL's bilinear filter on uint8 pixels (reference
evaluation.py:40-50); EvalConfig.resample="pil" runs that kernel in the
fused pyramid as two batched matmuls instead of one host resize per level.

What PIL (Pillow Resample.c, BILINEAR) does, reproduced here:
  scale       = in_size / out_size
  filterscale = max(scale, 1)          # antialias when downscaling
  support     = 1.0 * filterscale      # bilinear support = 1
  center      = (o + 0.5) * scale
  taps        = i in [int(center - support + 0.5),
                      min(in_size, int(center + support + 0.5)))
  weight(i)   = max(0, 1 - |i + 0.5 - center| / filterscale),
                normalized over the included taps, then quantized to fixed
                point at PRECISION_BITS = 22 (round away from zero);
  passes      = horizontal (width) first into an 8-bit temp image, then
                vertical — each emits clip8((ss + 2^21) >> 22), i.e. round
                half up.

`pil_bilinear_matrix_np` / `resize_pil_bilinear_np` are the float64 host
oracle, copied from the JAX package (byte-exact against PIL there,
tests/test_pilresize.py). `resize_pil_batch` is the batched version: per
image and axis a (out_pad, in_pad) weight matrix with the image's true
sizes masked inside the padded canvas, built in float64 with the oracle's
operations — the normalising sum of each row taken in NumPy's summation
order — so its weights equal the oracle's bit for bit. It applies them in
float64: a pixel (8 bits) times a weight k/2^22 needs 30 bits, every
partial sum is a multiple of 2^-22 below 2^9, so float64 holds each
product and sum exactly and the result is byte-equal to the oracle on any
device. (In float32 a product rounds at ~2^-16, and in TF32, which cuBLAS
takes for float32 wherever a caller has allowed it, at ~2^-3: bytes flip.)
"""

from __future__ import annotations

import numpy as np
import torch

PRECISION_BITS = 22  # Pillow: 32 - 8 - 2


def pil_bilinear_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """Host oracle: PIL's bilinear weight matrix (out_size, in_size),
    fixed-point-quantized exactly as Pillow's normalize_coeffs_8bpc
    (round away from zero at 2^22), returned as float64 multiples of
    2^-22."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    m = np.zeros((out_size, in_size))
    for o in range(out_size):
        center = (o + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        i = np.arange(xmin, xmax)
        w = np.clip(1.0 - np.abs(i + 0.5 - center) / filterscale, 0.0, None)
        s = w.sum()
        if s > 0:
            m[o, xmin:xmax] = w / s
    q = 1 << PRECISION_BITS
    return np.where(m < 0, np.ceil(m * q - 0.5), np.floor(m * q + 0.5)) / q


def resize_pil_bilinear_np(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Host oracle resize: byte-exact vs PIL Image.resize(BILINEAR) on
    uint8 input (width pass first, 8-bit intermediate, half-up
    rounding)."""
    sh = pil_bilinear_matrix_np(oh, img.shape[0])
    sw = pil_bilinear_matrix_np(ow, img.shape[1])
    y = np.einsum("ow,hwc->hoc", sw, img.astype(np.float64))
    y = np.clip(np.floor(y + 0.5), 0, 255)
    y = np.einsum("oh,hwc->owc", sh, y)
    return np.clip(np.floor(y + 0.5), 0, 255).astype(np.uint8)


def max_taps(in_sizes, out_sizes) -> int:
    """An upper bound on the taps of any row of the weight matrices that
    map in_sizes to out_sizes (arrays of true sizes): a window spans at
    most 2 * filterscale + 1 pixels."""
    fs = np.maximum(np.asarray(in_sizes, np.float64) / np.asarray(out_sizes, np.float64), 1.0)
    return int(2.0 * float(fs.max())) + 2


def _numpy_order_sum(taps: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim of taps (..., T), whose entries past n (...,)
    are zero, in the order NumPy's pairwise sum takes for n <= 128: one
    running sum for n < 8; else eight running sums over whole blocks of 8,
    combined as a tree, then the tail added one by one. Adding the zero
    padding is exact, so the result is NumPy's sum of the first n taps."""
    cols = taps.unbind(-1)
    total = torch.zeros_like(cols[0])
    for c in cols:
        total = total + c
    if len(cols) < 8:
        return total
    zero = torch.zeros_like(total)
    blocked = n - n % 8  # the end of the whole blocks
    r = list(cols[:8])
    for k in range(8, len(cols)):
        r[k % 8] = r[k % 8] + torch.where(k < blocked, cols[k], zero)
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(8, len(cols)):
        res = res + torch.where((k >= blocked) & (k < n), cols[k], zero)
    return torch.where(n >= 8, res, total)


def pil_weights(in_pad: int, out_pad: int, in_size: torch.Tensor, out_size: torch.Tensor,
                taps: int) -> torch.Tensor:
    """(B, out_pad, in_pad) float64 PIL bilinear weights for per-image true
    sizes in_size, out_size (B,) integer tensors: rows o >= out_size and
    columns i >= in_size are zero, and the (out_size, in_size) corner equals
    pil_bilinear_matrix_np(out_size, in_size). `taps` bounds the taps of a
    row (max_taps)."""
    dev = in_size.device
    f64 = torch.float64
    in_v = in_size.to(f64)[:, None, None]
    out_v = out_size.to(f64)[:, None, None]
    scale = in_v / out_v
    filterscale = torch.clamp_min(scale, 1.0)
    o = torch.arange(out_pad, dtype=f64, device=dev)[None, :, None]
    center = (o + 0.5) * scale  # (B, out_pad, 1)
    # The oracle's int() truncates toward zero; below zero both it and floor
    # clamp to 0, above it they agree.
    xmin = torch.clamp_min(torch.floor(center - filterscale + 0.5), 0.0)
    xmax = torch.minimum(torch.floor(center + filterscale + 0.5), in_v)
    n = torch.clamp_min(xmax - xmin, 0.0)

    def triangle(i):  # i: float64 pixel indices, broadcast against center
        return torch.clamp_min(1.0 - torch.abs(i + 0.5 - center) / filterscale, 0.0)

    k = torch.arange(taps, dtype=f64, device=dev)
    tap_w = torch.where(k < n, triangle(xmin + k), 0.0)  # (B, out_pad, taps)
    s = _numpy_order_sum(tap_w, n[..., 0].to(torch.int64))[..., None]
    i = torch.arange(in_pad, dtype=f64, device=dev)[None, None, :]
    inside = (i >= xmin) & (i < xmax) & (o < out_v) & (s > 0)
    m = torch.where(inside, triangle(i) / torch.where(s > 0, s, 1.0), 0.0)
    q = float(1 << PRECISION_BITS)
    return torch.floor(m * q + 0.5) / q  # weights are >= 0: round half up = away from zero


def _round8(y: torch.Tensor) -> torch.Tensor:
    """clip8((ss + 2^21) >> 22) == clip(floor(y + 0.5)) for y >= 0, in place."""
    return y.add_(0.5).floor_().clamp_(0.0, 255.0)


def resize_pil_batch(x: torch.Tensor, out_hw: tuple[int, int], size_hw: torch.Tensor,
                     level_hw: torch.Tensor, taps: tuple[int, int] | None = None) -> torch.Tensor:
    """Resize each canvas of x (B, C, H, W), pixel values 0..255 of any
    float dtype, to out_hw: image i's true (size_hw[i]) region to its
    level_hw[i] ((B, 2) integer tensors), PIL-bilinear matched (width pass,
    8-bit rounding, height pass, 8-bit rounding). Returns float64 (B, C,
    out_h, out_w) on the uint8 grid, zero outside each image's level size.
    `taps`: (rows, columns) bounds from max_taps; computed here (a device
    sync) when None."""
    b, c, h, w = x.shape
    if taps is None:
        sizes, levels = size_hw.cpu().numpy(), level_hw.cpu().numpy()
        taps = (max_taps(sizes[:, 0], levels[:, 0]), max_taps(sizes[:, 1], levels[:, 1]))
    wh = pil_weights(h, out_hw[0], size_hw[:, 0], level_hw[:, 0], taps[0])
    ww = pil_weights(w, out_hw[1], size_hw[:, 1], level_hw[:, 1], taps[1])
    x = x.to(torch.float64)
    # width first: (B, C*H, W) @ (B, W, out_w)
    y = _round8(torch.matmul(x.reshape(b, c * h, w), ww.transpose(1, 2)).reshape(b, c, h, out_hw[1]))
    return _round8(torch.matmul(wh[:, None], y))  # rows: (B, C, out_h, out_w)

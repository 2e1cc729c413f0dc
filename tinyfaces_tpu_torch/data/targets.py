"""Device-side batch preparation: normalization + GT target heatmaps.

Port of tinyfaces_tpu/data/targets.py on the `rgb`, `yuv420` and `jpegdct`
wires. The batch's tensors already sit on the training device; the yuv420
wire's planes are converted there (`yuv420_to_normalized`), the jpegdct
wire's pixels are reconstructed and augmented there (`device_augment_dct`),
and the assignment reductions run there (the CUDA kernel on a GPU, the plain
twin on the CPU).

`rgb_to_yuv420` is the yuv420 wire's host half, in NumPy: Pillow's
fixed-point RGB -> YCbCr converter (the JAX package calls PIL for it), byte
for byte, so no PIL is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyfaces_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, DetectorConfig
from tinyfaces_tpu_torch.ops.assignment import compute_pad_mask
from tinyfaces_tpu_torch.ops.assignment_kernel import assign_targets_fused


_constants: dict = {}


def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`values` as a tensor on `device`, uploaded once per (values, dtype,
    device) without a stream sync, so a caller can queue batches ahead and
    a CUDA graph can capture the ops that read it (a capture cannot copy
    from pageable host memory)."""
    key = (values, dtype, torch.device(device))
    if key not in _constants:
        _constants[key] = torch.tensor(values, dtype=dtype).to(device, non_blocking=True)
    return _constants[key]


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized float (ToTensor + ImageNet Normalize,
    reference main.py:44-46)."""
    mean = device_constant(IMAGENET_MEAN, dtype, images_u8.device)
    std = device_constant(IMAGENET_STD, dtype, images_u8.device)
    x = images_u8.to(dtype) / 255.0
    return (x - mean) / std


# Pillow's RGB -> YCbCr (libImaging/ConvertYCbCr.c): per output channel three
# 256-entry tables, entry i = (int)(coefficient * 64 * i + 0.5) in C (a
# truncation towards zero), summed and shifted right by 6 (a floor); Cb and
# Cr add 128. The coefficients are its five-digit JFIF ones.
_YCC_COEFFS = ((0.299, 0.587, 0.114),
               (-0.16874, -0.33126, 0.5),
               (0.5, -0.41869, -0.08131))
_YCC_TABLES = np.trunc(np.asarray(_YCC_COEFFS)[:, :, None] * 64.0 * np.arange(256)
                       + 0.5).astype(np.int16)  # (out channel, in channel, 256)


def _pil_ycbcr(rgb: np.ndarray) -> list[np.ndarray]:
    """(H, W, 3) uint8 RGB -> [Y, Cb, Cr], each (H, W) int16 holding
    Pillow's uint8 values."""
    out = []
    for c, tables in enumerate(_YCC_TABLES):
        acc = np.take(tables[0], rgb[..., 0])
        acc += np.take(tables[1], rgb[..., 1])
        acc += np.take(tables[2], rgb[..., 2])
        acc >>= 6
        if c:
            acc += 128
        out.append(acc)
    return out


def rgb_to_yuv420(images_u8: np.ndarray, out: tuple | None = None) -> tuple:
    """Host pack of the yuv420 wire: (B, H, W, 3) uint8 RGB -> planar YCbCr
    4:2:0, (B, H, W) Y and (B, H/2, W/2) Cb, Cr, all uint8 (H, W even).
    Y, Cb and Cr are Pillow's convert("YCbCr") exactly; each chroma sample
    is its 2x2 block's mean plus 0.5, truncated, as the JAX package takes
    it in float64 (an integer (sum + 2) >> 2, which is the same byte).
    `out`: the three arrays to write into, else new ones."""
    b, h, w, _ = images_u8.shape
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs an even canvas, got {h}x{w}")
    if out is None:
        out = (np.empty((b, h, w), np.uint8), np.empty((b, h // 2, w // 2), np.uint8),
               np.empty((b, h // 2, w // 2), np.uint8))
    y, u, v = out
    for i in range(b):
        yy, cb, cr = _pil_ycbcr(images_u8[i])
        y[i] = yy
        for plane, dst in ((cb, u), (cr, v)):
            quad = plane.reshape(h // 2, 2, w // 2, 2).sum((1, 3), dtype=np.int32)
            dst[i] = (quad + 2) >> 2
    return out


def yuv420_to_normalized(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Device unpack of the yuv420 wire: uint8 (B, H, W) Y and (B, H/2, W/2)
    Cb, Cr -> ImageNet-normalized RGB (B, H, W, 3) in `dtype`, computed in
    `dtype` throughout as the JAX package does (in bfloat16 the colour
    conversion itself runs in bfloat16): inverse full-range BT.601, nearest
    chroma upsample, clip to [0, 1], normalize."""
    yf = y.to(dtype)
    uf = u.to(dtype).repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0
    vf = v.to(dtype).repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1) - 128.0
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    x = (torch.stack([r, g, b], dim=-1) / 255.0).clamp_(0.0, 1.0)
    mean = device_constant(IMAGENET_MEAN, dtype, y.device)
    std = device_constant(IMAGENET_STD, dtype, y.device)
    return (x - mean) / std


def _taps(a: torch.Tensor, dim: int, start: int, stop: int, step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * a.dim()
    idx[dim] = slice(start, stop, step)
    return a[tuple(idx)]


def _pil_downscale2_dim(a: torch.Tensor, dim: int) -> torch.Tensor:
    """PIL BILINEAR x0.5 along `dim`: taps [2i-1 .. 2i+2] with weights
    [1/8, 3/8, 3/8, 1/8], edges clamped."""
    n = a.shape[dim]
    first, last = _taps(a, dim, 0, 1), _taps(a, dim, n - 1, n)
    ap = torch.cat([first, a, last, last], dim)
    out = (0.125 * _taps(ap, dim, 0, n, 2) + 0.375 * _taps(ap, dim, 1, n + 1, 2)
           + 0.375 * _taps(ap, dim, 2, n + 2, 2) + 0.125 * _taps(ap, dim, 3, n + 3, 2))
    # PIL drops out-of-image taps and renormalizes the rest (it does not
    # clamp): out[0] = (.75a0 + .75a1 + .25a2)/1.75. Region row 0 is only
    # consumed when it is the true image edge (crop at 0 => anchor at 0,
    # data/dct_train.region_anchor), so the fix-up is exact; the last row is
    # never consumed.
    head = (0.75 * first + 0.75 * _taps(a, dim, 1, 2) + 0.25 * _taps(a, dim, 2, 3)) / 1.75
    return torch.cat([head, _taps(out, dim, 1, out.shape[dim])], dim)


def _pil_downscale2(x: torch.Tensor) -> torch.Tensor:
    """Exact PIL BILINEAR x0.5 (the reference's Image.resize) of (B, H, W,
    C) -> (B, H/2, W/2, C): a separable triangle filter in float (no uint8
    re-quantization, a bounded deviation, see data/dct_train.py)."""
    return _pil_downscale2_dim(_pil_downscale2_dim(x, 1), 2)


def _pil_upscale2_dim(a: torch.Tensor, dim: int) -> torch.Tensor:
    n = a.shape[dim]
    ap = torch.cat([_taps(a, dim, 0, 1), a, _taps(a, dim, n - 1, n)], dim)
    even = 0.25 * _taps(ap, dim, 0, n) + 0.75 * _taps(ap, dim, 1, n + 1)
    odd = 0.75 * _taps(ap, dim, 1, n + 1) + 0.25 * _taps(ap, dim, 2, n + 2)
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([even, odd], dim + 1).reshape(shape)


def _pil_upscale2(x: torch.Tensor) -> torch.Tensor:
    """Exact PIL BILINEAR x2 of (B, h, w, C) -> (B, 2h, 2w, C): out[2j] =
    0.25 src[j-1] + 0.75 src[j], out[2j+1] = 0.75 src[j] + 0.25 src[j+1],
    edges clamped."""
    return _pil_upscale2_dim(_pil_upscale2_dim(x, 1), 2)


def device_augment_dct(batch: dict, cfg: DetectorConfig, dtype=torch.float32) -> torch.Tensor:
    """Device half of the jpegdct train wire (host half: data/dct_train.py):
    reconstruct each sample's source region in float32 (ops/jpeg.py), then
    the reference's resize, crop, paste and flip (wider_face.py:133-165),
    driven by the host's draws (aug_scale, aug_off, paste_box, flip), so
    the geometry is the host pixel path's exactly. Returns normalized (B,
    ih, iw, 3) in `dtype`.

    All three scale branches are computed for the whole batch and one is
    selected per sample (the x0.5 and x2 filters are a few passes over the
    region, small beside the step), so nothing waits on the host. The crop,
    the paste's roll and the flip are one gather per branch."""
    from tinyfaces_tpu_torch.data.dct_train import TRAIN_REGION, upsample_src
    from tinyfaces_tpu_torch.data.wider_face import MEAN_PIXEL
    from tinyfaces_tpu_torch.ops.jpeg import dct_batch_to_normalized

    ih, iw = cfg.input_size
    region = dct_batch_to_normalized({"_wire": batch["dct_wire"]}, TRAIN_REGION, TRAIN_REGION)
    dev = region.device
    branches = (_pil_downscale2(region), region,
                _pil_upscale2(region[:, :upsample_src(ih), :upsample_src(iw)]))

    b = region.shape[0]
    pb = batch["paste_box"].to(torch.float32)
    off = batch["aug_off"].to(torch.int64)
    sid = batch["aug_scale"].to(torch.int64)
    flip = batch["flip"].to(torch.bool)
    rows = torch.arange(ih, device=dev)
    cols = torch.where(flip[:, None], iw - 1 - torch.arange(iw, device=dev), torch.arange(iw, device=dev))
    # The paste at (px, py) is a roll of the crop; the mask below paints the
    # canvas fill wherever the rolled wrap-around lands outside the box.
    src_r = torch.remainder(rows[None] - pb[:, 1:2].to(torch.int64), ih)  # (B, ih)
    src_c = torch.remainder(cols - pb[:, 0:1].to(torch.int64), iw)  # (B, iw)
    bi = torch.arange(b, device=dev)[:, None, None]
    content = None
    for s, x in enumerate(branches):
        # a crop start clamped into the branch, as jax.lax.dynamic_slice
        oy = off[:, 0:1].clamp(0, x.shape[1] - ih)
        ox = off[:, 1:2].clamp(0, x.shape[2] - iw)
        crop = x[bi, (oy + src_r)[:, :, None], (ox + src_c)[:, None, :]]
        content = crop if content is None else torch.where((sid == s)[:, None, None, None], crop, content)

    mean_pixel = torch.tensor(MEAN_PIXEL, dtype=torch.float32) / 255.0
    fill = device_constant(tuple(((mean_pixel - torch.tensor(IMAGENET_MEAN))
                                  / torch.tensor(IMAGENET_STD)).tolist()), torch.float32, dev)
    rf, cf = rows.to(torch.float32)[None, :, None], cols.to(torch.float32)[:, None, :]
    inside = ((rf >= pb[:, 1, None, None]) & (rf < pb[:, 3, None, None])
              & (cf >= pb[:, 0, None, None]) & (cf < pb[:, 2, None, None]))
    return torch.where(inside[..., None], content, fill).to(dtype)


def build_targets(
    batch: dict,
    templates: torch.Tensor,
    generator: torch.Generator | None,
    cfg: DetectorConfig,
    noise_tensor: torch.Tensor | None = None,
    part: tuple[int, int] = (0, 1),
    seed: torch.Tensor | None = None,
):
    """Returns (images (B,H,W,3), class_maps (B,Y,X,T), regress_maps
    (B,Y,X,4T)). `noise_tensor` replaces the tie-break draws (CPU only),
    `seed` K1's per-image seeds. `part` = (rank, world) of a batch that is
    one rank's rows (assign_targets_fused)."""
    vsy, vsx = cfg.heatmap_size
    ofy, ofx = cfg.rf.offset
    sty, stx = cfg.rf.stride
    rf = dict(ofx=float(ofx), ofy=float(ofy), stx=float(stx), sty=float(sty))

    if "dct_wire" in batch:
        # jpegdct train wire: the source region's coefficients, augmented here
        images = device_augment_dct(batch, cfg)
    elif "image_y" in batch:
        # yuv420 wire (the loaders' pack="yuv420"): the colour conversion runs here
        images = yuv420_to_normalized(batch["image_y"], batch["image_u"], batch["image_v"])
    else:
        images = normalize_images(batch["image"])
    templates = templates.to(images.device, torch.float32)
    pad_masks = compute_pad_mask(batch["paste_box"], templates, vsx=vsx, vsy=vsy,
                                 flip=batch["flip"], **rf)
    cls_maps, reg_maps = assign_targets_fused(
        batch["gt_boxes"], batch["gt_valid"], pad_masks, templates, generator,
        pos_thresh=cfg.pos_thresh, neg_thresh=cfg.neg_thresh,
        noise_tensor=noise_tensor, part=part, seed=seed, **rf,
    )
    return images, cls_maps, reg_maps

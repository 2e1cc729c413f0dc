"""JPEG DCT-domain wire (`jpegdct`, wire version 3) — device half.

Port of tinyfaces_tpu/ops/jpeg.py, batched over images (no vmap). Takes the
(B, total) uint8 wire that data/jpegdct.pack_dct_batch packs and
reconstructs ImageNet-normalized RGB on the wire's device:

  view every field out of the byte buffer          (no copy)
  overwrite the escaped int8 ACs with their int16 values
  dequantize, dezigzag and 8x8 IDCT as ONE (Z+1, 64) basis product
  block grid -> plane                              (reshape/permute)
  chroma fancy upsample (libjpeg h2v2, edges replicated)
  BT.601 -> RGB, clip, /255, ImageNet normalization

Numerics: the basis product runs in float64 whatever the caller's TF32
setting (DC terms reach ~1024·q, which TF32's 10-bit mantissa would round by
~0.06 px); the rest is float32, cast to the caller's `dtype` at the end.
Plain PyTorch: no kernel of the JAX package's path is written by hand here.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyfaces_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from tinyfaces_tpu_torch.data.jpegdct import Z_KEEP_C, Z_KEEP_Y, ZIGZAG, _idct_matrix, wire_layout


def _zigzag_basis() -> np.ndarray:
    """(64, 64): row z is the 8x8 pixel basis (row-major) of the z-th
    zigzag coefficient, so pixels = coeff_zz @ BASIS."""
    m = _idct_matrix()
    basis = np.zeros((64, 64))
    for z in range(64):
        u, v = divmod(int(ZIGZAG[z]), 8)
        basis[z] = np.outer(m[u], m[v]).reshape(64)
    return basis


_BASIS_ZZ = _zigzag_basis()
_BASIS_ON: dict = {}  # device -> _BASIS_ZZ there, float64
_TORCH_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int16): torch.int16, np.dtype(np.uint16): torch.int16,
                 np.dtype(np.int32): torch.int32}


def wire_fields(wire_u8: torch.Tensor, h0p: int, w0p: int) -> dict:
    """Every field of the (B, total) uint8 wire as a (B, n) view of the same
    bytes (little-endian, as the host packed them). uint16 fields (the
    quant tables) come out widened to int32 without sign errors."""
    layout = wire_layout(h0p, w0p)
    total = layout.pop("__total__")
    if wire_u8.dtype != torch.uint8 or wire_u8.dim() != 2 or wire_u8.shape[1] != total:
        raise ValueError(f"wire must be (B, {total}) uint8, got {wire_u8.dtype} "
                         f"{tuple(wire_u8.shape)}")
    # A view to a wider dtype needs unit stride along bytes and offsets and
    # row strides aligned to the width: the layout aligns every field and
    # `total` is a multiple of 4, so only a foreign layout needs the copy.
    if wire_u8.stride(1) != 1 or wire_u8.stride(0) % 4 or wire_u8.storage_offset() % 4:
        wire_u8 = wire_u8.contiguous()
    fields = {}
    for name, (off, n, npdtype) in layout.items():
        arr = wire_u8[:, off:off + n * npdtype.itemsize].view(_TORCH_DTYPES[npdtype])
        if npdtype == np.uint16:
            arr = arr.to(torch.int32) & 0xFFFF
        fields[name] = arr
    return fields


def reconstruct_plane_dense(
    dc: torch.Tensor,  # (B, NB) int16 quantized DC
    ac: torch.Tensor,  # (B, NB, Z) int8 quantized zigzag ACs (clamped)
    esc_idx: torch.Tensor,  # (B, E) int32 flat index into NB*Z, -1 = unused
    esc_val: torch.Tensor,  # (B, E) int16 true value of escaped entries
    qtab: torch.Tensor,  # (B, 64) integer quant table, zigzag order
    nbh: int,
    nbw: int,
) -> torch.Tensor:
    """Zigzag-dense quantized coefficients -> (B, nbh*8, nbw*8) float32
    planes in [0, 255]."""
    b, nb, z = ac.shape
    # Escapes (|quantized AC| > 127, rare) overwrite their clamped int8.
    # Unused (-1) and out-of-range entries go to a dummy slot past the end,
    # so nothing wraps and nothing waits on the host.
    acf = torch.cat([ac.reshape(-1).to(torch.float32), ac.new_zeros(1, dtype=torch.float32)])
    esc = esc_idx.to(torch.int64)
    live = (esc >= 0) & (esc < nb * z)
    base = torch.arange(b, device=ac.device, dtype=torch.int64)[:, None] * (nb * z)
    flat = torch.where(live, base + esc, torch.full_like(esc, b * nb * z))
    acf.index_put_((flat.reshape(-1),), esc_val.reshape(-1).to(torch.float32))
    acf = acf[:-1].view(b, nb, z)

    q = qtab.to(torch.float32)
    coeff = torch.cat([dc.to(torch.float32)[..., None] * q[:, None, :1],
                       acf * q[:, None, 1:z + 1]], dim=2)
    # Uploaded once per device: a blocking upload on every call would wait
    # for the stream, and the device would idle while the host queued the rest.
    basis = _BASIS_ON.get(ac.device)
    if basis is None:
        basis = _BASIS_ON[ac.device] = torch.as_tensor(_BASIS_ZZ, device=ac.device)
    px = torch.matmul(coeff.to(torch.float64), basis[:z + 1]).to(torch.float32)
    plane = px.view(b, nbh, nbw, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, nbh * 8, nbw * 8)
    return (plane + 128.0).clamp_(0.0, 255.0)


def _fancy_upsample_1d(x: torch.Tensor, dim: int) -> torch.Tensor:
    """libjpeg 'fancy' (triangle) 2x upsample along `dim`: out[2i] =
    0.75 in[i] + 0.25 in[i-1], out[2i+1] = 0.75 in[i] + 0.25 in[i+1], the
    edge sample standing in for its missing neighbour."""
    n = x.shape[dim]
    lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    out = torch.stack([0.75 * x + 0.25 * lo, 0.75 * x + 0.25 * hi], dim + 1)
    shape = list(x.shape)
    shape[dim] *= 2
    return out.reshape(shape)


def fancy_upsample_2x(c: torch.Tensor) -> torch.Tensor:
    """(..., H/2, W/2) chroma -> (..., H, W), separable triangle filter."""
    return _fancy_upsample_1d(_fancy_upsample_1d(c, c.dim() - 2), c.dim() - 1)


def ycc_planes_to_normalized(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                             dtype=torch.float32) -> torch.Tensor:
    """Full-range BT.601 (JFIF) YCbCr planes in [0, 255] — y (B, H, W),
    cb/cr (B, H/2, W/2) — -> ImageNet-normalized RGB (B, H, W, 3) in
    `dtype`, with libjpeg's fancy chroma upsampling."""
    uf = fancy_upsample_2x(cb) - 128.0
    vf = fancy_upsample_2x(cr) - 128.0
    yf = y.to(torch.float32)
    r = yf + 1.402 * vf
    g = yf - 0.344136 * uf - 0.714136 * vf
    b = yf + 1.772 * uf
    x = torch.stack([r, g, b], dim=-1).clamp_(0.0, 255.0) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32).to(x.device, non_blocking=True)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32).to(x.device, non_blocking=True)
    return ((x - mean) / std).to(dtype)


def dct_batch_to_normalized(wire: dict, h0p: int, w0p: int, dtype=torch.float32) -> torch.Tensor:
    """Device unpack of pack_dct_batch's wire -> normalized RGB (B, h0p,
    w0p, 3) in `dtype`. Takes {"_wire": (B, total) uint8} or the field dict
    of wire_fields."""
    if "_wire" in wire:
        wire = wire_fields(wire["_wire"], h0p, w0p)
    nbh, nbw = h0p // 8, w0p // 8

    def rec(p, nh, nw, z):
        b = wire[f"{p}_ac"].shape[0]
        return reconstruct_plane_dense(wire[f"{p}_dc"], wire[f"{p}_ac"].reshape(b, nh * nw, z),
                                       wire[f"{p}_esc_idx"], wire[f"{p}_esc_val"],
                                       wire["q_y" if p == "y" else "q_c"], nbh=nh, nbw=nw)

    y = rec("y", nbh, nbw, Z_KEEP_Y)
    cb = rec("u", nbh // 2, nbw // 2, Z_KEEP_C)
    cr = rec("v", nbh // 2, nbw // 2, Z_KEEP_C)
    return ycc_planes_to_normalized(y, cb, cr, dtype=dtype)

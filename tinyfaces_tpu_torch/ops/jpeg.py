"""JPEG DCT-domain wires (`jpegdct` v3, `jpegdct4` v4) — device half.

Port of tinyfaces_tpu/ops/jpeg.py, batched over images (no vmap). Takes the
(B, total) uint8 wire that data/jpegdct.pack_dct_batch packs and
reconstructs ImageNet-normalized RGB on the wire's device:

  view every field out of the byte buffer          (no copy)
  v4 only: expand the bitmap-sparse values to the dense (NB, Z) tensor
  overwrite the escaped int8 ACs with their int16 values
  dequantize, dezigzag and 8x8 IDCT as ONE (Z+1, 64) basis product
  block grid -> plane                              (reshape/permute)
  chroma fancy upsample (libjpeg h2v2, edges replicated)
  BT.601 -> RGB, clip, /255, ImageNet normalization

Numerics: the basis product runs in float64 whatever the caller's TF32
setting (DC terms reach ~1024·q, which TF32's 10-bit mantissa would round by
~0.06 px); the rest is float32, cast to the caller's `dtype` at the end.

The v4 expansion (reconstruct_plane_sparse): each block's uint32 bitmap is
viewed out of the bytes as int32 and widened to int64 masked by 0xFFFFFFFF
(torch's uint32 takes few ops); a value's rank inside its block is a prefix
sum of the bitmap's bits, each block's offset into the value stream a prefix
sum of the blocks' SWAR popcounts, in row order or in 4:2:0 MCU order per
image (both computed, one selected, so nothing waits on the host); one
gather, clamped to the stream's last slot, fetches the values.
Plain PyTorch: no kernel of the JAX package's path is written by hand here.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyfaces_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD
from tinyfaces_tpu_torch.data.jpegdct import Z_KEEP_C, Z_KEEP_Y, ZIGZAG, _idct_matrix, layout_of
from tinyfaces_tpu_torch.data.targets import device_constant


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
                 np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.int32}


def wire_fields(wire_u8: torch.Tensor, h0p: int, w0p: int, version: int = 3) -> dict:
    """Every field of the (B, total) uint8 wire of `version` (3 or 4) as a
    (B, n) view of the same bytes (little-endian, as the host packed them).
    Unsigned fields come out widened without sign errors: uint16 (the quant
    tables) to int32, uint32 (v4's bitmaps) to int64."""
    layout = layout_of(version)(h0p, w0p)
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
        elif npdtype == np.uint32:
            arr = arr.to(torch.int64) & 0xFFFFFFFF
        fields[name] = arr
    return fields


def _dequantize_idct(dc: torch.Tensor, acf: torch.Tensor, esc_idx: torch.Tensor,
                     esc_val: torch.Tensor, qtab: torch.Tensor, nbh: int,
                     nbw: int) -> torch.Tensor:
    """Float32 ACs (B, NB, Z) with escapes still clamped -> (B, nbh*8,
    nbw*8) float32 planes in [0, 255]: the escape overwrite, dequantization,
    dezigzag and IDCT as one basis product, the block grid to a plane."""
    b, nb, z = acf.shape
    # Escapes (|quantized AC| > 127, rare) overwrite their clamped int8.
    # Unused (-1) and out-of-range entries go to a dummy slot past the end,
    # so nothing wraps and nothing waits on the host.
    acf = torch.cat([acf.reshape(-1), acf.new_zeros(1)])
    esc = esc_idx.to(torch.int64)
    live = (esc >= 0) & (esc < nb * z)
    base = torch.arange(b, device=acf.device, dtype=torch.int64)[:, None] * (nb * z)
    flat = torch.where(live, base + esc, torch.full_like(esc, b * nb * z))
    acf.index_put_((flat.reshape(-1),), esc_val.reshape(-1).to(torch.float32))
    acf = acf[:-1].view(b, nb, z)

    q = qtab.to(torch.float32)
    coeff = torch.cat([dc.to(torch.float32)[..., None] * q[:, None, :1],
                       acf * q[:, None, 1:z + 1]], dim=2)
    # Uploaded once per device: a blocking upload on every call would wait
    # for the stream, and the device would idle while the host queued the rest.
    basis = _BASIS_ON.get(acf.device)
    if basis is None:
        basis = _BASIS_ON[acf.device] = torch.as_tensor(_BASIS_ZZ, device=acf.device)
    px = torch.matmul(coeff.to(torch.float64), basis[:z + 1]).to(torch.float32)
    plane = px.view(b, nbh, nbw, 8, 8).permute(0, 1, 3, 2, 4).reshape(b, nbh * 8, nbw * 8)
    return (plane + 128.0).clamp_(0.0, 255.0)


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
    return _dequantize_idct(dc, ac.to(torch.float32), esc_idx, esc_val, qtab, nbh, nbw)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 in [0, 2^32) (SWAR, exact in int64)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def _stream_offsets(pc: torch.Tensor, nbh: int, nbw: int,
                    order: torch.Tensor | None) -> torch.Tensor:
    """(B, NB) int64 offsets of each block's values in its image's stream,
    from the blocks' popcounts pc (B, NB): canvas row-major order, or where
    order[i] > 0 4:2:0 MCU order (MCU raster, inside an MCU (0,0), (0,1),
    (1,0), (1,1)). Canvas blocks outside the image's MCU grid have pc 0, so
    the prefix sum over the canvas's MCU raster is the image's."""
    row = torch.cumsum(pc, dim=1) - pc
    if order is None:
        return row
    b = pc.shape[0]
    mh, mw = nbh // 2, nbw // 2
    pcg = pc.view(b, mh, 2, mw, 2)
    mcu_tot = pcg.sum(dim=(2, 4)).reshape(b, -1)
    mcu_pre = (torch.cumsum(mcu_tot, dim=1) - mcu_tot).view(b, mh, mw)
    w01 = pcg[:, :, 0, :, 0]
    w10 = w01 + pcg[:, :, 0, :, 1]
    w11 = w10 + pcg[:, :, 1, :, 0]
    within = torch.stack([torch.stack([torch.zeros_like(w01), w01], 1),
                          torch.stack([w10, w11], 1)], 1)  # (B, dy, dx, mh, mw)
    mcu = (mcu_pre[:, None, None] + within).permute(0, 3, 1, 4, 2).reshape(b, -1)
    return torch.where(order[:, None] > 0, mcu, row)


def reconstruct_plane_sparse(
    dc: torch.Tensor,  # (B, NB) int16 quantized DC
    bitmap: torch.Tensor,  # (B, NB) int64 in [0, 2^32): bit k-1 = zigzag position k
    vals: torch.Tensor,  # (B, V) int8 packed nonzero values (clamped)
    esc_idx: torch.Tensor,  # (B, E) int32 flat index into NB*Z, -1 = unused
    esc_val: torch.Tensor,  # (B, E) int16 true value of escaped entries
    qtab: torch.Tensor,  # (B, 64) integer quant table, zigzag order
    nbh: int,
    nbw: int,
    z: int,
    order: torch.Tensor | None = None,  # (B,) Y stream order, None = row order
) -> torch.Tensor:
    """Bitmap-sparse (wire v4) coefficients -> (B, nbh*8, nbw*8) float32
    planes in [0, 255]: the dense (B, NB, Z) ACs by prefix sums and one
    gather, then as reconstruct_plane_dense."""
    b, nb = dc.shape
    zz = torch.arange(z, device=dc.device, dtype=torch.int64)
    present = (bitmap[..., None] >> zz) & 1  # (B, NB, Z)
    # rank of a value inside its block = popcount(bitmap & ((1 << k) - 1))
    rank = torch.cumsum(present, dim=2) - present
    offs = _stream_offsets(_popcount32(bitmap), nbh, nbw, order)
    idx = (offs[..., None] + rank).clamp_(max=vals.shape[1] - 1)
    gathered = torch.gather(vals, 1, idx.view(b, -1)).view(b, nb, z)
    acf = torch.where(present != 0, gathered.to(torch.float32), 0.0)
    return _dequantize_idct(dc, acf, esc_idx, esc_val, qtab, nbh, nbw)


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
    mean = device_constant(IMAGENET_MEAN, torch.float32, x.device)
    std = device_constant(IMAGENET_STD, torch.float32, x.device)
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


def dct4_batch_to_normalized(wire: dict, h0p: int, w0p: int, dtype=torch.float32) -> torch.Tensor:
    """Device unpack of the version-4 (bitmap-sparse) wire -> normalized RGB
    (B, h0p, w0p, 3) in `dtype`, as dct_batch_to_normalized. Y's value
    stream is in the order h0w0[:, 2] names, per image; chroma's in row
    order."""
    if "_wire" in wire:
        wire = wire_fields(wire["_wire"], h0p, w0p, version=4)
    nbh, nbw = h0p // 8, w0p // 8

    def rec(p, nh, nw, z, order=None):
        return reconstruct_plane_sparse(wire[f"{p}_dc"], wire[f"{p}_bm"], wire[f"{p}_vals"],
                                        wire[f"{p}_esc_idx"], wire[f"{p}_esc_val"],
                                        wire["q_y" if p == "y" else "q_c"], nbh=nh, nbw=nw, z=z,
                                        order=order)

    y = rec("y", nbh, nbw, Z_KEEP_Y, order=wire["h0w0"][:, 2])
    cb = rec("u", nbh // 2, nbw // 2, Z_KEEP_C)
    cr = rec("v", nbh // 2, nbw // 2, Z_KEEP_C)
    return ycc_planes_to_normalized(y, cb, cr, dtype=dtype)

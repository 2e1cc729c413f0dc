"""JPEG DCT-domain wires (`jpegdct`, wire version 3, and `jpegdct4`, version
4) — host half.

Port of tinyfaces_tpu/data/jpegdct.py. The host entropy-decodes JPEG files
with the port's copy of the C++ decoder (csrc/jpeg_dct.cpp, no libjpeg) and
packs the quantized coefficients into one fixed-shape byte buffer per batch;
the GPU dequantizes, inverts the DCT, upsamples the chroma and normalizes
(ops/jpeg.py). Version 3 is
zigzag-dense (~0.68 B/px against the rgb canvas's 3); version 4 is
bitmap-sparse (~0.34-0.38 B/px): per block a uint32 bitmap of the nonzero
zigzag positions and one image-wide int8 stream of the nonzero values, whose
per-block offsets the device rebuilds from popcount prefix sums.

The decoder takes baseline and extended-sequential Huffman JPEGs with
4:2:0 sampling or one component. Anything else (progressive or
arithmetic-coded files, 4:2:2/4:4:4 chroma, CMYK, other formats), and
uint8 arrays, go through PIL: a transcode to baseline 4:2:0 at quality 95,
counted by `transcode_count()`. PIL is imported only there. Where it is not
installed such an input raises `TranscodeUnavailable`, naming the file's
sampling; nothing decodes it some other way.

The library is built at first use (utils/cuda_build.load_host_library) and
its exports (both versions' packers) are checked when it is loaded; a
failed build or load, or a library without them, raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import io
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from tinyfaces_tpu_torch.utils.cuda_build import load_host_library

# JPEG zigzag order: ZIGZAG[i] = row-major index of the i-th zigzag entry.
ZIGZAG = np.array([
     0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# Zigzag cutoff per plane: each block ships its DC (int16) plus the first
# Z quantized AC coefficients as dense int8; dropping the tail is a
# spectral low-pass, counted in truncation_stats(). Escapes carry the
# |q| > 127 values, up to ESC_PER_BLOCK of them per block.
Z_KEEP_Y = 28
Z_KEEP_C = 24
ESC_PER_BLOCK = 1 / 16
PACK_THREADS = 4  # images of one batch packed side by side (the C++ calls drop the GIL)

# Wire v4: the nonzero values within the same zigzag cutoffs ride one int8
# stream per plane, VALS_PER_BLOCK_* per block of the canvas, image-wide
# (smooth blocks pay for textured ones). A stream that overflows drops its
# highest-zigzag values (a spectral low-pass, counted in truncation_stats).
VALS_PER_BLOCK_Y = 12
VALS_PER_BLOCK_C = 5

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_transcodes = 0
_truncated_coeffs = 0
_clamped_escapes = 0

_P = ctypes.c_void_p
_L = ctypes.c_long
_I = ctypes.c_int
_SIGNATURES = {
    "tf_jpeg_info": (_I, [_P, _L, _P]),
    "tf_jpeg_dct": (_I, [_P, _L, _P, _L, _P, _L, _P, _L, _P, _P]),
    "tf_dct_pack_dense": (None, [_P, _I, _I, _I, _I, _I, _L, ctypes.c_int16,
                                 _P, _P, _P, _P, _P]),
    "tf_jpeg_dct_pack": (_I, [_P, _L, _I, _I, _I, _I, _L, _L, ctypes.c_float,
                              ctypes.c_float, ctypes.c_float] + [_P] * 16),
    "tf_dct_pack_sparse": (None, [_P, _I, _I, _I, _I, _I, _L, _L, ctypes.c_int16] + [_P] * 6),
    "tf_jpeg_dct_pack_sparse": (_I, [_P, _L, _I, _I, _I, _I, _L, _L, _L, _L, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_float] + [_P] * 19),
}


class TranscodeUnavailable(RuntimeError):
    """An input the native decoder does not take needs PIL's transcode to
    baseline 4:2:0, and PIL is not installed."""


@dataclasses.dataclass
class DCTImage:
    """Entropy-decoded JPEG: quantized coefficients at component resolution.

    y/cb/cr: (nblocks_y, nblocks_x, 64) int16, ZIGZAG coefficient order.
    qy/qc: (64,) uint16 quant tables, zigzag order. Grayscale: cb/cr None.
    """

    h: int
    w: int
    y: np.ndarray
    cb: Optional[np.ndarray]
    cr: Optional[np.ndarray]
    qy: np.ndarray
    qc: Optional[np.ndarray]


def load() -> ctypes.CDLL:
    """Build (if needed) and load csrc/jpeg_dct.cpp, check that it exports
    the six entry points the bindings call (v3's and v4's) and type them;
    raises on any failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = load_host_library("jpeg_dct")
        missing = [name for name in _SIGNATURES if not hasattr(lib, name)]
        if missing:
            raise RuntimeError(f"jpeg_dct library lacks {missing}: not the decoder the bindings expect")
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


def transcode_count() -> int:
    """How many inputs took the PIL transcode (non-baseline or non-4:2:0
    files, uint8 arrays)."""
    return _transcodes


def _pil_jpeg(save, why: str) -> bytes:
    """Baseline 4:2:0 quality-95 JPEG bytes from `save(Image)`; raises
    TranscodeUnavailable naming `why` where PIL is not installed."""
    global _transcodes
    try:
        from PIL import Image
    except ImportError as e:
        raise TranscodeUnavailable(
            f"{why}: the transcode to baseline 4:2:0 needs PIL, which is not installed") from e
    with _lock:
        _transcodes += 1
    buf = io.BytesIO()
    save(Image).save(buf, "JPEG", quality=95, subsampling=2)
    return buf.getvalue()


def _transcode(data: bytes, why: str) -> bytes:
    """Decode anything PIL reads and re-encode it as baseline 4:2:0."""

    def save(Image):
        img = Image.open(io.BytesIO(data))
        return img if img.mode in ("RGB", "L") else img.convert("RGB")

    return _pil_jpeg(save, why)


def _info(lib, data: bytes) -> tuple[int, np.ndarray]:
    buf = np.frombuffer(data, np.uint8)
    info = np.zeros(8, np.int32)
    rc = lib.tf_jpeg_info(buf.ctypes.data_as(_P), len(buf), info.ctypes.data_as(_P))
    return rc, info


def _native_dims(rc: int, info: np.ndarray) -> Optional[tuple[int, int]]:
    """(h, w) when the header is one the native decoder takes, else None."""
    ncomp, hs, vs = (int(v) for v in info[2:5])
    if rc != 0 or not (ncomp == 1 or (hs == 2 and vs == 2)):
        return None
    return int(info[0]), int(info[1])


def _describe(rc: int, info: np.ndarray) -> str:
    h, w, ncomp, hs, vs, progressive = (int(v) for v in info[:6])
    if rc != 0 and h == 0:
        return f"not a JPEG the native decoder parses (rc={rc})"
    kind = "progressive" if progressive else ("unsupported" if rc else "baseline")
    return (f"{kind} JPEG {h}x{w}, {ncomp} components, sampling={hs}x{vs} (rc={rc}): "
            f"not baseline 4:2:0 or grayscale")


def parse_jpeg_dct(data: bytes) -> DCTImage:
    """JPEG bytes -> quantized DCT coefficients (C++ entropy decode only).
    Files the native decoder does not take are transcoded through PIL."""
    lib = load()
    try:
        return _parse_native(lib, data)
    except ValueError as e:
        return _parse_native(lib, _transcode(data, str(e)))


def _parse_native(lib, data: bytes) -> DCTImage:
    rc, info = _info(lib, data)
    if _native_dims(rc, info) is None:
        raise ValueError(_describe(rc, info))
    h, w, ncomp, hs, vs = (int(v) for v in info[:5])
    if ncomp == 1:
        nby, nbx = -(-h // 8), -(-w // 8)
        nbcy = nbcx = 0
    else:
        mcy, mcx = -(-h // (8 * vs)), -(-w // (8 * hs))
        nby, nbx = mcy * vs, mcx * hs
        nbcy, nbcx = mcy, mcx

    buf = np.frombuffer(data, np.uint8)
    y = np.zeros((nby * nbx, 64), np.int16)
    cb = np.zeros((max(1, nbcy * nbcx), 64), np.int16)
    cr = np.zeros_like(cb)
    qt = np.zeros((3, 64), np.uint16)
    grid = np.zeros(8, np.int32)
    rc = lib.tf_jpeg_dct(buf.ctypes.data_as(_P), len(buf), y.ctypes.data_as(_P), y.shape[0],
                         cb.ctypes.data_as(_P), cb.shape[0], cr.ctypes.data_as(_P), cr.shape[0],
                         qt.ctypes.data_as(_P), grid.ctypes.data_as(_P))
    if rc != 0:
        raise ValueError(f"jpeg entropy decode failed (rc={rc})")
    if (int(grid[0]), int(grid[1])) != (nby, nbx):
        raise RuntimeError(f"jpeg_dct block grid {grid[:2]} is not the header's ({nby}, {nbx})")

    if ncomp == 1:
        return DCTImage(h, w, y.reshape(nby, nbx, 64), None, None, qt[0].copy(), None)
    return DCTImage(h, w, y.reshape(nby, nbx, 64), cb.reshape(nbcy, nbcx, 64),
                    cr.reshape(nbcy, nbcx, 64), qt[0].copy(), qt[1].copy())


def jpeg_dims(data: bytes) -> Optional[tuple[int, int]]:
    """(h, w) if `data` is a JPEG the fused native path decodes directly
    (baseline Huffman, 4:2:0 or grayscale), else None. Header parse only:
    callers size the batch canvas with it and keep the raw bytes for
    pack_dct_batch."""
    return _native_dims(*_info(load(), data))


def is_bytes(im) -> bool:
    return isinstance(im, (bytes, bytearray, memoryview))


def as_dct_image(im) -> DCTImage:
    """Detector input -> DCTImage: passthrough for DCTImage, entropy decode
    for JPEG bytes, a PIL encode (q95 4:2:0, a transcode) for uint8 arrays."""
    if isinstance(im, DCTImage):
        return im
    if is_bytes(im):
        return parse_jpeg_dct(bytes(im))
    arr = np.asarray(im)
    if arr.dtype == np.uint8 and arr.ndim in (2, 3):
        why = f"a uint8 array of shape {arr.shape} on the jpegdct wire"
        return parse_jpeg_dct(_pil_jpeg(lambda Image: Image.fromarray(arr), why))
    raise TypeError(f"jpegdct transfer takes JPEG bytes, DCTImage or uint8 arrays, "
                    f"got {type(im).__name__}")


def as_wire_input(im):
    """A detector input made ready for pack_dct_batch: JPEG bytes the fused
    C++ pack takes stay raw (a header parse here, the entropy decode at pack
    time); anything else is entropy-decoded now (as_dct_image)."""
    if is_bytes(im) and jpeg_dims(bytes(im)) is not None:
        return im
    return as_dct_image(im)


def input_dims(im) -> tuple[int, int]:
    """(h, w) of a detector input: an (H, W, 3) uint8 array, a DCTImage or
    JPEG bytes as as_wire_input leaves them."""
    if isinstance(im, DCTImage):
        return im.h, im.w
    if is_bytes(im):
        dims = jpeg_dims(bytes(im))
        if dims is None:
            raise ValueError("JPEG bytes the fused C++ pack does not take: pass as_wire_input(data)")
        return dims
    return im.shape[:2]


# --- NumPy reference reconstruction (tests / offline use) ----------------

def _idct_matrix() -> np.ndarray:
    """M[u, x] = c(u)/2 * cos((2x+1) u pi / 16); pixels = M^T F M."""
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0] *= 1 / np.sqrt(2)
    return m


def reconstruct_plane_np(coef_zz: np.ndarray, qtab_zz: np.ndarray) -> np.ndarray:
    """(nby, nbx, 64) zigzag quantized -> (nby*8, nbx*8) float pixels in
    [0, 255]. Reference for the device reconstruction's tests."""
    nby, nbx, _ = coef_zz.shape
    dense = np.zeros((nby * nbx, 64), np.float64)
    dense[:, ZIGZAG] = coef_zz.reshape(-1, 64) * qtab_zz.astype(np.float64)
    f = dense.reshape(nby, nbx, 8, 8)
    m = _idct_matrix()
    px = np.einsum("ux,bcuv,vy->bcxy", m, f, m)
    plane = px.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8) + 128.0
    return np.clip(plane, 0.0, 255.0)


# --- Batch packing for the device --------------------------------------

def truncation_stats() -> dict:
    """Nonzero AC coefficients past the zigzag cutoff, and escape values
    clamped to +-127 when the escape budget overflowed (never silent)."""
    return {"truncated_coeffs": _truncated_coeffs, "clamped_escapes": _clamped_escapes}


def _count(stats) -> None:
    global _truncated_coeffs, _clamped_escapes
    if stats[0] or stats[1]:
        with _lock:
            _truncated_coeffs += int(stats[0])
            _clamped_escapes += int(stats[1])


def _neutral_ycc() -> tuple[float, float, float]:
    """MEAN_PIXEL (the canvas fill everywhere else in the pipeline) in
    full-range BT.601 YCbCr."""
    from tinyfaces_tpu_torch.data.wider_face import MEAN_PIXEL

    r, g, b = MEAN_PIXEL
    yy = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return yy, cb, cr


def _pack_plane_dense(coef_zz, nbx_img, w_grid, z_keep, out_dc, out_ac, out_esc_idx,
                      out_esc_val) -> None:
    """NumPy oracle of tf_dct_pack_dense: zigzag-dense pack of one plane.
    coef_zz: (nb_img, 64) int16 zigzag; image blocks land at canvas block id
    by*w_grid + bx; out_ac is (canvas_blocks, z_keep) int8."""
    nb_img = coef_zz.shape[0]
    img_cids = (np.arange(nb_img) // nbx_img) * w_grid + (np.arange(nb_img) % nbx_img)

    out_dc[img_cids] = coef_zz[:, 0]
    ac = coef_zz[:, 1:z_keep + 1].astype(np.int16)
    small = np.clip(ac, -127, 127)
    out_ac[img_cids] = small.astype(np.int8)

    rows, ks = np.nonzero(ac != small)
    ne = min(rows.shape[0], out_esc_idx.shape[0])
    out_esc_idx[:ne] = img_cids[rows[:ne]] * z_keep + ks[:ne]
    out_esc_val[:ne] = ac[rows[:ne], ks[:ne]]
    _count((int(np.count_nonzero(coef_zz[:, z_keep + 1:])), rows.shape[0] - ne))


def _pack_plane_dense_native(lib, coef_zz, nbx_img, grid_h, grid_w, z_keep, neutral_dc,
                             out_dc, out_ac, out_esc_idx, out_esc_val) -> None:
    """C++ pack of one plane (tf_dct_pack_dense), held to the oracle."""
    stats = np.zeros(2, np.int32)
    coef_zz = np.ascontiguousarray(coef_zz, np.int16)
    lib.tf_dct_pack_dense(
        coef_zz.ctypes.data_as(_P), coef_zz.shape[0] // nbx_img, nbx_img, grid_h, grid_w,
        z_keep, out_esc_idx.shape[0], ctypes.c_int16(int(neutral_dc)),
        out_dc.ctypes.data_as(_P), out_ac.ctypes.data_as(_P),
        out_esc_idx.ctypes.data_as(_P), out_esc_val.ctypes.data_as(_P),
        stats.ctypes.data_as(_P))
    _count(stats)


def _pack_fused_native(lib, data: bytes, wire: dict, i: int, h8: int,
                       w8: int) -> Optional[tuple[int, int]]:
    """Fused C++ entropy decode + pack (tf_jpeg_dct_pack): JPEG bytes ->
    this image's wire fields, no intermediate coefficient buffers. Returns
    (h, w), or None if the stream needs the transcode and the two-pass
    path. Escapes come in MCU decode order (row-major in the two-pass
    path); the device overwrite is order-free."""
    buf = np.frombuffer(data, np.uint8)
    stats = np.zeros(2, np.int32)
    hw = np.zeros(2, np.int32)
    yn, cbn, crn = _neutral_ycc()
    planes = [wire[f"{p}_{f}"][i] for p in "yuv" for f in ("dc", "ac", "esc_idx", "esc_val")]
    rc = lib.tf_jpeg_dct_pack(
        buf.ctypes.data_as(_P), len(buf), h8, w8, Z_KEEP_Y, Z_KEEP_C,
        wire["y_esc_idx"].shape[1], wire["u_esc_idx"].shape[1],
        float(yn), float(cbn), float(crn),
        *[a.ctypes.data_as(_P) for a in planes],
        wire["q_y"][i].ctypes.data_as(_P), wire["q_c"][i].ctypes.data_as(_P),
        hw.ctypes.data_as(_P), stats.ctypes.data_as(_P))
    if rc != 0:
        return None
    _count(stats)
    return int(hw[0]), int(hw[1])


def _pack_plane_sparse(coef_zz, nbx_img, w_grid, z_keep, vcap, out_dc, out_bm, out_vals,
                       out_esc_idx, out_esc_val) -> None:
    """NumPy oracle of tf_dct_pack_sparse: bitmap-sparse pack of one plane,
    its value stream in canvas row-major block order (the order of the
    image's own blocks too). coef_zz: (nb_img, 64) int16 zigzag; out_bm is
    (canvas_blocks,) uint32 (bit k-1 = zigzag position k), out_vals (vcap,)
    int8."""
    nb_img = coef_zz.shape[0]
    img_cids = (np.arange(nb_img) // nbx_img) * w_grid + (np.arange(nb_img) % nbx_img)

    out_dc[img_cids] = coef_zz[:, 0]
    ac = coef_zz[:, 1:z_keep + 1].astype(np.int16)
    rows, ks = np.nonzero(ac)  # row-major == stream order
    keep = np.arange(rows.shape[0]) < vcap
    rows, ks, overflow = rows[keep], ks[keep], int(rows.shape[0] - keep.sum())

    bm = np.zeros(nb_img, np.uint32)
    np.add.at(bm, rows, np.uint32(1) << ks.astype(np.uint32))
    out_bm[img_cids] = bm
    v = ac[rows, ks]
    clipped = np.clip(v, -127, 127)
    out_vals[:clipped.shape[0]] = clipped.astype(np.int8)

    esc = np.nonzero(v != clipped)[0]
    ne = min(esc.shape[0], out_esc_idx.shape[0])
    out_esc_idx[:ne] = img_cids[rows[esc[:ne]]] * z_keep + ks[esc[:ne]]
    out_esc_val[:ne] = v[esc[:ne]]
    _count((overflow + int(np.count_nonzero(coef_zz[:, z_keep + 1:])), esc.shape[0] - ne))


def _pack_plane_sparse_native(lib, coef_zz, nbx_img, grid_h, grid_w, z_keep, neutral_dc,
                              out_dc, out_bm, out_vals, out_esc_idx, out_esc_val) -> None:
    """C++ pack of one plane (tf_dct_pack_sparse), held to the oracle."""
    stats = np.zeros(2, np.int32)
    coef_zz = np.ascontiguousarray(coef_zz, np.int16)
    lib.tf_dct_pack_sparse(
        coef_zz.ctypes.data_as(_P), coef_zz.shape[0] // nbx_img, nbx_img, grid_h, grid_w,
        z_keep, out_esc_idx.shape[0], out_vals.shape[0], ctypes.c_int16(int(neutral_dc)),
        *[a.ctypes.data_as(_P) for a in (out_dc, out_bm, out_vals, out_esc_idx, out_esc_val,
                                         stats)])
    _count(stats)


def _pack_fused_native_v4(lib, data: bytes, wire: dict, i: int, h8: int,
                          w8: int) -> Optional[tuple[int, int, int]]:
    """Fused C++ entropy decode + bitmap-sparse pack (tf_jpeg_dct_pack_sparse).
    Returns (h, w, stream_order), or None if the stream needs the transcode
    and the two-pass path. A colour scan writes the Y value stream in 4:2:0
    MCU order (stream order 1), a grayscale one in row order (0); the device
    rebuilds the offsets of either."""
    buf = np.frombuffer(data, np.uint8)
    stats = np.zeros(2, np.int32)
    hw = np.zeros(3, np.int32)
    yn, cbn, crn = _neutral_ycc()
    planes = [wire[f"{p}_{f}"][i] for p in "yuv" for f in ("dc", "bm", "vals", "esc_idx", "esc_val")]
    rc = lib.tf_jpeg_dct_pack_sparse(
        buf.ctypes.data_as(_P), len(buf), h8, w8, Z_KEEP_Y, Z_KEEP_C,
        wire["y_esc_idx"].shape[1], wire["u_esc_idx"].shape[1],
        wire["y_vals"].shape[1], wire["u_vals"].shape[1],
        float(yn), float(cbn), float(crn),
        *[a.ctypes.data_as(_P) for a in planes],
        wire["q_y"][i].ctypes.data_as(_P), wire["q_c"][i].ctypes.data_as(_P),
        hw.ctypes.data_as(_P), stats.ctypes.data_as(_P))
    if rc != 0:
        return None
    _count(stats)
    return int(hw[0]), int(hw[1]), 1 if int(hw[2]) == 3 else 0


def _layout(fields) -> dict:
    """(name, n, dtype) -> the layout dict: each field aligned to its width,
    the total rounded up to a multiple of 4."""
    layout = {}
    off = 0
    for name, n, dtype in fields:
        item = np.dtype(dtype).itemsize
        off = (off + item - 1) // item * item  # natural alignment
        layout[name] = (off, n, np.dtype(dtype))
        off += n * item
    layout["__total__"] = (off + 3) // 4 * 4
    return layout


def _grid(h0p: int, w0p: int) -> tuple[int, int, int, int]:
    """(Y blocks, chroma blocks, Y escape slots, chroma escape slots)."""
    if h0p % 16 or w0p % 16:
        raise ValueError(f"canvas {h0p}x{w0p} is not a multiple of 16")
    nb = (h0p // 8) * (w0p // 8)
    nbc = (h0p // 16) * (w0p // 16)
    return nb, nbc, max(16, int(nb * ESC_PER_BLOCK)), max(16, int(nbc * ESC_PER_BLOCK))


def _shared_fields(nb: int, nbc: int, ey: int, ec: int) -> tuple[list, list]:
    """The fields both versions carry, in wire order: the escape indices,
    then the DC planes, the escape values and the quant tables."""
    per_plane = lambda name, ns, dt: [(f"{p}_{name}", n, dt) for p, n in zip("yuv", ns)]  # noqa: E731
    return (per_plane("esc_idx", (ey, ec, ec), np.int32),
            per_plane("dc", (nb, nbc, nbc), np.int16) + per_plane("esc_val", (ey, ec, ec), np.int16)
            + [("q_y", 64, np.uint16), ("q_c", 64, np.uint16)])


def wire_layout(h0p: int, w0p: int) -> dict:
    """Field -> (byte_offset, n_elements, dtype) layout of one image's row
    of the version-3 wire, plus "__total__" -> its bytes (a multiple of 4).

    Every field — DC planes, zigzag-dense AC tensors, escape lists, quant
    tables and the [h, w] of the image — rides in one byte buffer per
    batch, so a batch is one upload. Each offset is aligned to its field's
    width, so the device views every field out of the bytes in place
    (ops/jpeg.wire_fields)."""
    nb, nbc, ey, ec = _grid(h0p, w0p)
    esc_idx, shared = _shared_fields(nb, nbc, ey, ec)
    return _layout([("h0w0", 2, np.int32)] + esc_idx + shared + [
        ("y_ac", nb * Z_KEEP_Y, np.int8), ("u_ac", nbc * Z_KEEP_C, np.int8),
        ("v_ac", nbc * Z_KEEP_C, np.int8)])


def wire_layout_v4(h0p: int, w0p: int) -> dict:
    """The version-4 (bitmap-sparse) layout, as wire_layout. h0w0 is [h, w,
    Y stream order, 0]: order 1 is 4:2:0 MCU order (the fused colour
    decode), 0 canvas row-major (the two-pass pack, grayscale). Stream
    offsets are not on the wire: the device rebuilds them from popcounts."""
    nb, nbc, ey, ec = _grid(h0p, w0p)
    esc_idx, shared = _shared_fields(nb, nbc, ey, ec)
    return _layout([("h0w0", 4, np.int32), ("y_bm", nb, np.uint32), ("u_bm", nbc, np.uint32),
                    ("v_bm", nbc, np.uint32)] + esc_idx + shared + [
        ("y_vals", nb * VALS_PER_BLOCK_Y, np.int8), ("u_vals", nbc * VALS_PER_BLOCK_C, np.int8),
        ("v_vals", nbc * VALS_PER_BLOCK_C, np.int8)])


def layout_of(version: int):
    """wire_layout for version 3, wire_layout_v4 for 4."""
    if version not in (3, 4):
        raise ValueError(f"unknown wire version {version}")
    return wire_layout_v4 if version == 4 else wire_layout


def pack_dct_batch(dcts: Sequence, h0p: int, w0p: int, use_native: bool = True,
                   wire_version: int = 3, out: Optional[np.ndarray] = None) -> dict:
    """Pack entropy-decoded images into the fixed-shape device wire of
    `wire_version` (3 zigzag-dense, 4 bitmap-sparse).

    Entries may be DCTImage, raw JPEG bytes or uint8 arrays. Raw bytes of a
    baseline 4:2:0 or grayscale JPEG take the fused C++ decode + pack;
    everything else goes through as_dct_image and the two-pass per-plane
    pack. h0p/w0p: the padded canvas (multiples of 16); padding blocks
    decode to the MEAN_PIXEL canvas fill. Returns {"_wire": (B, total)
    uint8} — the one upload — plus zero-copy per-field views.
    `use_native=False` packs with the NumPy oracle (raw bytes still parse
    in C++). `out`: a (B, total) uint8 C-contiguous array to pack into
    (e.g. pinned memory), else a new one."""
    v4 = wire_version == 4
    layout = layout_of(wire_version)(h0p, w0p)
    b = len(dcts)
    h8, w8, h16, w16 = h0p // 8, w0p // 8, h0p // 16, w0p // 16
    total = layout.pop("__total__")
    data_end = max(off + n * dt.itemsize for off, n, dt in layout.values())
    if out is None:
        # empty, not zeros: the fused path writes every field region itself;
        # two-pass rows are zeroed in pack_image
        out = np.empty((b, total), np.uint8)
    elif out.shape != (b, total) or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous ({b}, {total}) uint8 array, "
                         f"got {out.dtype} {out.shape}")
    wire = {"_wire": out}
    out[:, data_end:] = 0  # tail alignment pad
    for name, (off, n, dtype) in layout.items():
        wire[name] = out[:, off:off + n * dtype.itemsize].view(dtype)

    yn, cbn, crn = _neutral_ycc()
    lib = load()

    def pack_one(coef, nbx_img, grid_h, grid_w, z_keep, neutral_dc, p, i):
        fields = [wire[f"{p}_dc"][i]]
        if v4:
            fields += [wire[f"{p}_bm"][i], wire[f"{p}_vals"][i]]
        else:
            fields.append(wire[f"{p}_ac"][i].reshape(grid_h * grid_w, z_keep))
        fields += [wire[f"{p}_esc_idx"][i], wire[f"{p}_esc_val"][i]]
        if use_native:
            native = _pack_plane_sparse_native if v4 else _pack_plane_dense_native
            native(lib, coef, nbx_img, grid_h, grid_w, z_keep, neutral_dc, *fields)
        else:
            fields[0][:] = neutral_dc
            if v4:
                _pack_plane_sparse(coef, nbx_img, grid_w, z_keep, fields[2].shape[0], *fields)
            else:
                _pack_plane_dense(coef, nbx_img, grid_w, z_keep, *fields)

    def pack_image(i: int) -> None:
        d = dcts[i]
        if use_native and is_bytes(d):
            fused = _pack_fused_native_v4 if v4 else _pack_fused_native
            hw = fused(lib, bytes(d), wire, i, h8, w8)
            if hw is not None:
                wire["h0w0"][i] = (*hw, 0) if v4 else hw
                return
        if not isinstance(d, DCTImage):
            d = as_dct_image(d)  # bytes that need the transcode, uint8 arrays
        # the two-pass path writes sparsely into zeroed fields
        out[i, :data_end].fill(0)
        for p in "yuv":
            wire[f"{p}_esc_idx"][i].fill(-1)
        # v4's two-pass path packs Y in canvas row-major order (stream order 0)
        wire["h0w0"][i] = (d.h, d.w, 0, 0) if v4 else (d.h, d.w)
        # quant tables ship in zigzag order, as the AC tensors and the basis
        wire["q_y"][i] = d.qy
        wire["q_c"][i] = d.qc if d.qc is not None else d.qy

        # neutral (canvas-fill) DC for blocks no image content covers: the
        # quantized DC of a flat block of value v is 8*(v-128)/q
        ndc_y = np.round(8.0 * (yn - 128.0) / float(d.qy[0]))
        qc0 = float((d.qc if d.qc is not None else d.qy)[0])
        ndc_u = np.round(8.0 * (cbn - 128.0) / qc0)
        ndc_v = np.round(8.0 * (crn - 128.0) / qc0)

        pack_one(d.y.reshape(-1, 64), d.y.shape[1], h8, w8, Z_KEEP_Y, ndc_y, "y", i)
        if d.cb is not None:
            pack_one(d.cb.reshape(-1, 64), d.cb.shape[1], h16, w16, Z_KEEP_C, ndc_u, "u", i)
            pack_one(d.cr.reshape(-1, 64), d.cr.shape[1], h16, w16, Z_KEEP_C, ndc_v, "v", i)
        else:
            # grayscale: flat neutral-gray chroma (Cb = Cr = 128 -> DC 0)
            wire["u_dc"][i] = 0
            wire["v_dc"][i] = 0

    if use_native and b > 1:
        with ThreadPoolExecutor(min(PACK_THREADS, b)) as pool:  # disjoint rows
            list(pool.map(pack_image, range(b)))
    else:
        for i in range(b):
            pack_image(i)
    return wire


def wire_bytes(wire: dict) -> int:
    """Bytes of a packed batch's one upload."""
    return wire["_wire"].nbytes

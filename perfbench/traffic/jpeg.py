"""A baseline JPEG encoder (4:2:0, optimal Huffman tables) whose quantized
coefficients the harness keeps, and their exact decode.

The eval cells' images are made here so that the reference knows what each
file holds: `encode` returns the JPEG bytes the port reads and the
quantized DCT coefficients they carry; `decode` turns those coefficients
into pixels by the JPEG arithmetic itself, with no rounding anywhere:
dequantisation, the 8x8 inverse DCT, libjpeg's "fancy" h2v2 chroma
upsampling (a 9-3-3-1 triangle, edges repeated), the JFIF YCbCr -> RGB
conversion, then a clip to [0, 255]. A library decoder (libjpeg's integer
IDCT, rounding at every stage) differs from it by up to several levels,
which the seeded ResNet-101 carries into its logits.

A side that is not a multiple of 16 is padded to one by repeating the last
row or column, as libjpeg pads its last MCU; the file states the true size
and `decode` returns that much.
"""

from __future__ import annotations

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
# ITU T.81 Annex K.1, natural (row-major) order.
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
CHROMA_Q = np.full(64, 99, np.int64)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56,
                                                           47, 66]


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's scaling of an Annex K table to `quality` (1-100)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    c = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
    c[0] /= np.sqrt(2)
    return c


C = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)  # (by, bx, 8, 8)


def _unblocks(b: np.ndarray) -> np.ndarray:
    by, bx = b.shape[:2]
    return b.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)


def coefficients(image: np.ndarray, quality: int) -> dict:
    """The quantized DCT coefficients (natural order, (by, bx, 8, 8)) of
    the Y, Cb and Cr planes of an RGB uint8 image, padded to whole 16x16
    MCUs, Cb and Cr averaged 2x2; "size" is the image's own."""
    size = image.shape[:2]
    image = np.pad(image, ((0, -size[0] % 16), (0, -size[1] % 16), (0, 0)), mode="edge")
    h, w = image.shape[:2]
    rgb = image.astype(np.float64)
    y = rgb @ np.array([0.299, 0.587, 0.114])
    cb = rgb @ np.array([-0.168736, -0.331264, 0.5]) + 128.0
    cr = rgb @ np.array([0.5, -0.418688, -0.081312]) + 128.0
    sub = lambda p: p.reshape(h // 2, 2, w // 2, 2).mean((1, 3))  # noqa: E731
    qy, qc = quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)
    out = {"qy": qy, "qc": qc, "size": np.array(size)}
    for name, plane, q in (("y", y, qy), ("cb", sub(cb), qc), ("cr", sub(cr), qc)):
        d = C @ (_blocks(plane) - 128.0) @ C.T
        out[name] = np.round(d / q.reshape(8, 8)).astype(np.int64)
    return out


def decode(coefs: dict) -> np.ndarray:
    """(H, W, 3) float64 RGB in [0, 255] of the coefficients, exactly."""
    planes = {}
    for name, q in (("y", coefs["qy"]), ("cb", coefs["qc"]), ("cr", coefs["qc"])):
        planes[name] = _unblocks(C.T @ (coefs[name] * q.reshape(8, 8)) @ C) + 128.0
    cb, cr = _fancy_h2v2(planes["cb"]), _fancy_h2v2(planes["cr"])
    y = planes["y"]
    rgb = np.stack([y + 1.402 * (cr - 128.0),
                    y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0),
                    y + 1.772 * (cb - 128.0)], -1)
    h, w = (int(v) for v in coefs["size"])
    return np.clip(rgb[:h, :w], 0.0, 255.0)


def _fancy_h2v2(p: np.ndarray) -> np.ndarray:
    """libjpeg's h2v2 fancy upsampling without its rounding: each output is
    9/16 of the nearest sample, 3/16 of each of the two next nearest, 1/16
    of the diagonal one, the edge samples repeated."""
    up = np.concatenate([p[:1], p[:-1]])
    down = np.concatenate([p[1:], p[-1:]])
    rows = np.empty((2 * p.shape[0], p.shape[1]))
    rows[0::2] = 3 * p + up
    rows[1::2] = 3 * p + down
    left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]))
    out[:, 0::2] = (3 * rows + left) / 16.0
    out[:, 1::2] = (3 * rows + right) / 16.0
    return out


def _size(v: np.ndarray) -> np.ndarray:
    """JPEG's magnitude category: the bit length of |v|."""
    a = np.abs(v)
    s = np.zeros(a.shape, np.int64)
    nz = a > 0
    s[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return s


def _extra(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.where(v >= 0, v, v + (1 << s) - 1)


def _huffman(freq: np.ndarray) -> tuple[list, list, dict]:
    """libjpeg's optimal table (jpeg_gen_optimal_table): code lengths of at
    most 16 bits, no code of all ones. Returns (BITS, HUFFVAL, symbol ->
    (code, length))."""
    f = np.zeros(257, np.int64)
    f[: len(freq)] = freq
    f[256] = 1
    size = np.zeros(257, np.int64)
    others = np.full(257, -1)
    while True:
        live = np.nonzero(f > 0)[0]
        if len(live) < 2:
            break
        order = sorted(live, key=lambda i: (f[i], -i))
        c1, c2 = order[0], order[1]
        f[c1] += f[c2]
        f[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = np.bincount(size[size > 0], minlength=33)
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    vals = [int(s) for s in sorted(np.nonzero(size[:256])[0], key=lambda s: (size[s], s))]
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return [int(b) for b in bits[1:17]], vals, codes


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def encode(image: np.ndarray, quality: int) -> tuple[bytes, dict]:
    """(baseline 4:2:0 JPEG bytes, their coefficients) of an RGB uint8
    image."""
    co = coefficients(image, quality)
    h, w = image.shape[:2]
    my, mx = co["y"].shape[0] // 2, co["y"].shape[1] // 2
    y = co["y"].reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, 4, 64)
    blocks = np.concatenate([y, co["cb"].reshape(-1, 1, 64), co["cr"].reshape(-1, 1, 64)], 1)
    comp = np.tile([0, 0, 0, 0, 1, 2], my * mx)
    zz = blocks.reshape(-1, 64)[:, ZIGZAG]  # MCU order
    nb = len(zz)
    dc = zz[:, 0]
    diff = np.empty(nb, np.int64)
    for c in range(3):
        sel = comp == c
        diff[sel] = np.diff(dc[sel], prepend=0)
    table = np.minimum(comp, 1)  # 0 luma, 1 chroma
    ev_block, ev_key, ev_table, ev_sym, ev_val, ev_len = [], [], [], [], [], []

    def add(block, key, tab, sym, val, length):
        ev_block.append(block)
        ev_key.append(key)
        ev_table.append(tab)
        ev_sym.append(sym)
        ev_val.append(val)
        ev_len.append(length)

    s = _size(diff)
    add(np.arange(nb), np.zeros(nb, np.int64), table, s, _extra(diff, s), s)
    ac = zz[:, 1:]
    bi, j = np.nonzero(ac)
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, -1, np.concatenate([[0], j[:-1]]))
    run = j - prev - 1
    z = run // 16
    zb = np.repeat(bi, z)
    add(zb, np.repeat(2 * j + 1, z), 2 + table[zb], np.full(len(zb), 0xF0), np.zeros(len(zb), np.int64),
        np.zeros(len(zb), np.int64))
    v = ac[bi, j]
    s = _size(v)
    add(bi, 2 * j + 2, 2 + table[bi], ((run % 16) << 4) | s, _extra(v, s), s)
    last = np.full(nb, -1)
    last[bi] = j  # the last nonzero AC of each block (j ascends within a block)
    eob = np.nonzero(last < 62)[0]
    add(eob, np.full(len(eob), 200), 2 + table[eob], np.zeros(len(eob), np.int64),
        np.zeros(len(eob), np.int64), np.zeros(len(eob), np.int64))
    cat = lambda xs: np.concatenate([np.asarray(x, np.int64) for x in xs])  # noqa: E731
    blk, key, tab, sym, val, ln = (cat(x) for x in (ev_block, ev_key, ev_table, ev_sym, ev_val, ev_len))
    order = np.lexsort((key, blk))
    tab, sym, val, ln = tab[order], sym[order], val[order], ln[order]
    tables = []
    code = np.zeros(len(sym), np.int64)
    clen = np.zeros(len(sym), np.int64)
    for t in range(4):
        sel = tab == t
        bits, vals, codes = _huffman(np.bincount(sym[sel], minlength=256))
        tables.append((bits, vals))
        lut_c = np.zeros(256, np.int64)
        lut_l = np.zeros(256, np.int64)
        for k, (cv, cl) in codes.items():
            lut_c[k], lut_l[k] = cv, cl
        code[sel], clen[sel] = lut_c[sym[sel]], lut_l[sym[sel]]
    pv = np.stack([code, val], 1).reshape(-1)
    pl = np.stack([clen, ln], 1).reshape(-1)
    keep = pl > 0
    pv, pl = pv[keep], pl[keep]
    total = int(pl.sum())
    start = np.repeat(np.cumsum(pl) - pl, pl)
    shift = np.repeat(pl, pl) - 1 - (np.arange(total) - start)
    bitstream = (np.repeat(pv, pl) >> shift) & 1
    bitstream = np.concatenate([bitstream, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    data = np.packbits(bitstream)
    data = np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0)
    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _segment(0xDB, bytes([0]) + bytes(co["qy"][ZIGZAG].astype(np.uint8))
                    + bytes([1]) + bytes(co["qc"][ZIGZAG].astype(np.uint8)))
    out += _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                    + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls_id, (bits, vals) in zip((0x00, 0x01, 0x10, 0x11), tables):
        out += _segment(0xC4, bytes([cls_id]) + bytes(bits) + bytes(vals))
    out += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    out += data.tobytes() + b"\xff\xd9"
    return bytes(out), co

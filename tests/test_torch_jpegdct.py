"""The port's `jpegdct` wire (data/jpegdct.py, ops/jpeg.py) against the JAX
package's on the CPU.

Host half, exact: the port's copy of the C++ decoder is the JAX package's
code; both read the same coefficients and quant tables from PIL-made JPEGs
(q75/q90/q95, grayscale, odd sizes, restart intervals 0/1/5) and from the
committed fixtures (tests/torch_jpeg/); they pack the same wire byte for
byte from raw bytes, DCTImage and uint8 arrays, on the native and the NumPy
pack, with equal truncation counts. Without PIL a file that needs the
transcode raises, naming its sampling, and a baseline file still parses.
Device half: planes within 1e-3 in [0, 255] (tests/test_jpegdct.py's
atol), normalized RGB within 2e-5.
"""

import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_jpegdct import encode, encode_jpeg_gray_dri, natural_image
from tests.test_torch_native import jax_native_library  # noqa: F401
from tests.torch_jpeg.make_fixtures import FIXTURE_DIR, MANIFEST, SPECS, coef_sha256
from tinyfaces_tpu.data import jpegdct as jax_jpegdct
from tinyfaces_tpu.ops import jpeg as jax_ops
from tinyfaces_tpu_torch.data import jpegdct
from tinyfaces_tpu_torch.ops import jpeg as ops
from tinyfaces_tpu_torch.utils import cuda_build

ROOT = FIXTURE_DIR.parents[1]


def _code(path):
    """A C++ source without its leading header comment."""
    lines = path.read_text().splitlines()
    i = 0
    while i < len(lines) and (lines[i].startswith("//") or not lines[i].strip()):
        i += 1
    return lines[i:]


def _sine_jpeg():
    """A strong 16-px sinusoid at q95: low-frequency ACs beyond 127, so the
    escape lists are exercised, and nonzero tails past the cutoff."""
    xx = np.mgrid[0:248, 0:312][1]
    sine = (128 + 110 * np.sin(xx * 2 * np.pi / 16)).clip(0, 255).astype(np.uint8)
    return encode(np.stack([sine] * 3, -1), quality=95)


def _jpegs():
    noise = np.random.default_rng(9).integers(0, 256, (97, 131, 3), dtype=np.uint8)
    return [_sine_jpeg(), encode(natural_image(120, 200, seed=5), quality=75),
            encode(natural_image(248, 312, seed=7, color=False), quality=88),
            encode(noise, quality=95)]  # white noise: ACs past the zigzag cutoff


def _assert_same_dct(got, want):
    assert (got.h, got.w) == (want.h, want.w)
    for k in ("y", "cb", "cr", "qy", "qc"):
        g, w = getattr(got, k), getattr(want, k)
        assert (g is None) == (w is None), k
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_decoder_source_is_the_jax_packages():
    assert _code(ROOT / "tinyfaces_tpu_torch/csrc/jpeg_dct.cpp") == _code(ROOT / "native/jpeg_dct.cpp")


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "jpeg_dct.cpp").write_text("#error broken decoder source\n")
    monkeypatch.setattr(cuda_build, "CSRC", src)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(jpegdct, "_lib", None)
    data = encode(natural_image(64, 64), quality=90)
    for call in (jpegdct.load, lambda: jpegdct.parse_jpeg_dct(data),
                 lambda: jpegdct.jpeg_dims(data), lambda: jpegdct.pack_dct_batch([data], 64, 64)):
        with pytest.raises(RuntimeError, match="broken decoder source"):
            call()
    # a library without the decoder's exports fails the load check
    (src / "jpeg_dct.cpp").write_text('extern "C" int tf_jpeg_info() { return 0; }\n')
    monkeypatch.setattr(cuda_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="lacks"):
        jpegdct.load()


@pytest.mark.parametrize("case", ["q75", "q90", "q95", "gray", "odd", "gray_odd", "4:4:4"])
def test_parse_matches_jax(case):
    img = natural_image(*((101, 157) if "odd" in case else (128, 160)), seed=3,
                        color="gray" not in case)
    if "gray" in case:
        data = encode(img[..., 0], quality=85)
    elif case == "4:4:4":  # not native: both take the PIL transcode
        data = encode(img, quality=90, subsampling=0)
    else:
        data = encode(img, quality=int(case[1:]) if case[0] == "q" else 90)
    n = jpegdct.transcode_count()
    _assert_same_dct(jpegdct.parse_jpeg_dct(data), jax_jpegdct.parse_jpeg_dct(data))
    assert jpegdct.jpeg_dims(data) == jax_jpegdct.jpeg_dims(data)
    assert jpegdct.transcode_count() == n + (case == "4:4:4")


@pytest.mark.parametrize("dri", [0, 1, 5])
def test_restart_interval_streams_match_jax(dri):
    rng = np.random.default_rng(17 + dri)
    nby, nbx = 6, 5
    coef = np.zeros((nby, nbx, 64), np.int16)
    coef.reshape(-1, 64)[:, 0] = rng.integers(-80, 80, nby * nbx)
    coef.reshape(-1, 64)[:, 1:12] = rng.integers(-20, 20, (nby * nbx, 11))
    q = rng.integers(1, 40, 64).astype(np.uint16)
    data = encode_jpeg_gray_dri(coef, q, nby * 8, nbx * 8, restart_interval=dri)
    got = jpegdct.parse_jpeg_dct(data)
    _assert_same_dct(got, jax_jpegdct.parse_jpeg_dct(data))
    np.testing.assert_array_equal(got.y, coef)
    np.testing.assert_array_equal(
        jpegdct.pack_dct_batch([data], 48, 48)["_wire"],
        jax_jpegdct.pack_dct_batch([data], 48, 48)["_wire"])


def test_fixtures_match_the_manifest_and_jax():
    manifest = json.loads(MANIFEST.read_text())
    assert list(manifest) == [s[0] for s in SPECS]
    total = 0
    for name, entry in manifest.items():
        data = (FIXTURE_DIR / name).read_bytes()
        total += len(data)
        assert len(data) == entry["bytes"]
        if entry["kind"] == "progressive":
            assert jpegdct.jpeg_dims(data) is None and "coef_sha256" not in entry
            continue
        assert jpegdct.jpeg_dims(data) == (entry["h"], entry["w"])
        theirs = jax_jpegdct.parse_jpeg_dct(data)
        assert coef_sha256(theirs) == entry["coef_sha256"], name  # re-derived by the JAX package
        ours = jpegdct.parse_jpeg_dct(data)
        assert coef_sha256(ours) == entry["coef_sha256"], name
        assert (ours.cb is None) == (entry["kind"] == "gray")
        if entry["kind"] == "baseline" and entry["h"] >= 683:
            assert 2.5e5 <= len(data) <= 6e5, name
    assert total <= 4 << 20


def _stats_delta(mod, fn):
    before = mod.truncation_stats()
    out = fn()
    after = mod.truncation_stats()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("kind", ["bytes", "dct", "array"])
@pytest.mark.parametrize("native", [True, False])
def test_pack_is_jax_byte_for_byte(kind, native):
    jpegs = _jpegs()
    if kind == "bytes":
        ours, theirs = jpegs, jpegs
    elif kind == "dct":
        ours = [jpegdct.parse_jpeg_dct(j) for j in jpegs]
        theirs = [jax_jpegdct.parse_jpeg_dct(j) for j in jpegs]
    else:
        arrays = [np.asarray(Image.open(io.BytesIO(j)).convert("RGB")) for j in jpegs]
        ours = theirs = arrays
    got, dg = _stats_delta(jpegdct, lambda: jpegdct.pack_dct_batch(ours, 256, 320, use_native=native))
    want, dw = _stats_delta(jax_jpegdct,
                            lambda: jax_jpegdct.pack_dct_batch(theirs, 256, 320, use_native=native))
    assert got["_wire"].shape == want["_wire"].shape == (4, jpegdct.wire_layout(256, 320)["__total__"])
    np.testing.assert_array_equal(got["_wire"], want["_wire"])
    assert dg == dw
    if kind != "array":
        assert (got["y_esc_idx"] >= 0).sum() > 0 and dg["truncated_coeffs"] > 0
    # packed into a caller's buffer, the same bytes
    out = np.full_like(got["_wire"], 7)
    jpegdct.pack_dct_batch(ours, 256, 320, use_native=native, out=out)
    np.testing.assert_array_equal(out, want["_wire"])
    assert jpegdct.wire_bytes(got) == jax_jpegdct.wire_bytes(want)


def test_transcode_with_and_without_pil(monkeypatch):
    prog = (FIXTURE_DIR / "progressive_120x160_q85.jpg").read_bytes()
    base = (FIXTURE_DIR / "odd_197x263_q90.jpg").read_bytes()
    n = jpegdct.transcode_count()
    _assert_same_dct(jpegdct.parse_jpeg_dct(prog), jax_jpegdct.parse_jpeg_dct(prog))
    assert jpegdct.transcode_count() == n + 1

    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` now fails
    for call in (lambda: jpegdct.parse_jpeg_dct(prog), lambda: jpegdct.as_dct_image(prog),
                 lambda: jpegdct.pack_dct_batch([prog], 128, 160)):
        with pytest.raises(jpegdct.TranscodeUnavailable, match=r"progressive .*sampling=2x2.*needs PIL"):
            call()
    with pytest.raises(jpegdct.TranscodeUnavailable, match="uint8 array.*needs PIL"):
        jpegdct.as_dct_image(np.zeros((16, 16, 3), np.uint8))
    assert jpegdct.transcode_count() == n + 1
    _assert_same_dct(jpegdct.parse_jpeg_dct(base), jax_jpegdct.parse_jpeg_dct(base))
    assert jpegdct.jpeg_dims(base) == (197, 263)


def test_wire_version_4_is_not_ported():
    """Wire version 4 is ported (tests/test_torch_jpegdct4.py); an unknown
    version, a canvas off the 16-px grid and a foreign input raise."""
    assert jpegdct.pack_dct_batch(_jpegs()[:1], 256, 320, wire_version=4)["_wire"].shape == (
        1, jpegdct.wire_layout_v4(256, 320)["__total__"])
    with pytest.raises(ValueError, match="wire version"):
        jpegdct.pack_dct_batch(_jpegs()[:1], 256, 320, wire_version=5)
    with pytest.raises(ValueError, match="multiple of 16"):
        jpegdct.wire_layout(100, 320)
    with pytest.raises(TypeError, match="JPEG bytes"):
        jpegdct.as_dct_image(np.zeros((4, 4), np.float32))


def _wire():
    return jpegdct.pack_dct_batch(_jpegs(), 256, 320)["_wire"]


def test_wire_fields_match_jax():
    w = _wire()
    theirs = jax_ops.wire_fields(jnp.asarray(w), 256, 320)
    for src in (torch.from_numpy(w), torch.from_numpy(np.pad(w, ((0, 0), (1, 3))))[:, 1:-3]):
        ours = ops.wire_fields(src, 256, 320)
        assert ours.keys() == theirs.keys()
        for k, v in ours.items():
            np.testing.assert_array_equal(v.numpy().astype(np.int64),
                                          np.asarray(theirs[k]).astype(np.int64), err_msg=k)
    assert ours["q_y"].dtype == torch.int32 and int(ours["q_y"].min()) >= 1
    assert ours["h0w0"].tolist() == [[248, 312], [120, 200], [248, 312], [97, 131]]
    with pytest.raises(ValueError, match="uint8"):
        ops.wire_fields(torch.from_numpy(w).to(torch.int16), 256, 320)


def test_reconstruction_matches_jax():
    w = _wire()
    theirs = jax_ops.wire_fields(jnp.asarray(w), 256, 320)
    ours = ops.wire_fields(torch.from_numpy(w), 256, 320)
    for p, nh, nw, z in (("y", 32, 40, jpegdct.Z_KEEP_Y), ("u", 16, 20, jpegdct.Z_KEEP_C),
                         ("v", 16, 20, jpegdct.Z_KEEP_C)):
        q = "q_y" if p == "y" else "q_c"
        got = ops.reconstruct_plane_dense(ours[f"{p}_dc"], ours[f"{p}_ac"].reshape(4, nh * nw, z),
                                          ours[f"{p}_esc_idx"], ours[f"{p}_esc_val"], ours[q],
                                          nbh=nh, nbw=nw)
        for i in range(4):
            want = jax_ops.reconstruct_plane_dense(
                theirs[f"{p}_dc"][i], theirs[f"{p}_ac"][i].reshape(nh * nw, z),
                theirs[f"{p}_esc_idx"][i], theirs[f"{p}_esc_val"][i], theirs[q][i], nbh=nh, nbw=nw)
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-3, rtol=0)
    for dtype, jdtype, atol in ((torch.float32, jnp.float32, 2e-5), (torch.bfloat16, jnp.bfloat16, 2e-2)):
        got = ops.dct_batch_to_normalized({"_wire": torch.from_numpy(w)}, 256, 320, dtype=dtype)
        want = np.asarray(jax_ops.dct_batch_to_normalized({"_wire": jnp.asarray(w)}, 256, 320,
                                                          dtype=jdtype), np.float32)
        assert got.dtype == dtype and tuple(got.shape) == (4, 256, 320, 3)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want, atol=atol, rtol=0)
    # the luma plane equals the float64 NumPy reference where no tail was cut
    d = jpegdct.parse_jpeg_dct(_jpegs()[1])
    ref = jpegdct.reconstruct_plane_np(d.y, d.qy)
    y = ops.reconstruct_plane_dense(ours["y_dc"][1:2], ours["y_ac"][1:2].reshape(1, 1280, 28),
                                    ours["y_esc_idx"][1:2], ours["y_esc_val"][1:2], ours["q_y"][1:2],
                                    nbh=32, nbw=40)[0, :ref.shape[0], :ref.shape[1]]
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-3)


def test_upsample_and_colour_conversion_match_jax():
    rng = np.random.default_rng(4)
    c = rng.uniform(0, 255, (3, 12, 17)).astype(np.float32)
    np.testing.assert_allclose(ops.fancy_upsample_2x(torch.from_numpy(c)).numpy(),
                               np.asarray(jax_ops.fancy_upsample_2x(jnp.asarray(c))), atol=1e-5, rtol=0)
    y = rng.uniform(0, 255, (3, 24, 34)).astype(np.float32)
    cb, cr = (rng.uniform(0, 255, (3, 12, 17)).astype(np.float32) for _ in range(2))
    got = ops.ycc_planes_to_normalized(*(torch.from_numpy(a) for a in (y, cb, cr)))
    want = jax_ops.ycc_planes_to_normalized(*(jnp.asarray(a) for a in (y, cb, cr)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)

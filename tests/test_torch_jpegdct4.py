"""The port's `jpegdct4` wire (wire version 4, bitmap-sparse) against the
JAX package's on the CPU.

Host half, exact: the layout equals the JAX package's; the v4 wire is the
JAX package's byte for byte from raw bytes, DCTImage and uint8 arrays, on
the native (fused and two-pass) and the NumPy pack, for colour and
grayscale images, with value-stream overflow and with escapes, with equal
truncation counts. Device half: every field view equals the JAX
package's, planes within 1e-3 in [0, 255] and normalized RGB within 2e-5
of `dct4_batch_to_normalized`, and bit-equal to the port's own v3
reconstruction wherever nothing was truncated (MCU-order and row-order
streams). The pyramid, sweep, service and detect_image on jpegdct4 match
the JAX package's: the same survivors, boxes within 1e-2 px, scores
within 1e-3.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import detect_image as jax_detect_image
from tests.test_jpegdct import encode, natural_image
from tests.test_torch_evaluate_cli import _tree
from tests.test_torch_evaluation import (EC, PROB, SCALES, TEMPLATES, TINY, assert_same_detections,
                                         shared_weights)
from tests.test_torch_jpegdct import _jpegs, _stats_delta
from tests.test_torch_jpegdct_eval import jpegs
from tests.test_torch_native import jax_native_library  # noqa: F401
from tests.test_torch_yuv420 import assert_same_sweeps, assert_service_matches_detect_batch
from tinyfaces_tpu import evaluation as jax_eval
from tinyfaces_tpu.config import DetectorConfig
from tinyfaces_tpu.data import WIDERFace as JaxWIDERFace
from tinyfaces_tpu.data import jpegdct as jax_jpegdct
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.ops import jpeg as jax_ops
from tinyfaces_tpu_torch import detect_image
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.data import WIDERFace, jpegdct
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.ops import jpeg as ops
from tinyfaces_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("hw", [(64, 64), (128, 192), (256, 320), (768, 1024)])
def test_layout_equals_jax(hw):
    layout = jpegdct.wire_layout_v4(*hw)
    assert layout == jax_jpegdct.wire_layout_v4(*hw)
    assert jpegdct.layout_of(4) is jpegdct.wire_layout_v4 and jpegdct.layout_of(3) is jpegdct.wire_layout
    total = layout.pop("__total__")
    assert total % 4 == 0 and all(off % dt.itemsize == 0 for off, _, dt in layout.values())
    if hw == (768, 1024):
        assert total / (768 * 1024) < 0.5 < jpegdct.wire_layout(*hw)["__total__"] / (768 * 1024)
    with pytest.raises(ValueError, match="wire version"):
        jpegdct.layout_of(5)


@pytest.mark.parametrize("kind", ["bytes", "dct", "array"])
@pytest.mark.parametrize("native", [True, False])
def test_pack_is_jax_byte_for_byte(kind, native):
    """The sine JPEG escapes, the white-noise one overflows the value stream
    and cuts zigzag tails, the last is a one-component JPEG."""
    data = _jpegs() + [encode(natural_image(120, 160, seed=2, color=False)[..., 0], quality=90)]
    if kind == "bytes":
        ours = theirs = data
    elif kind == "dct":
        ours = [jpegdct.parse_jpeg_dct(j) for j in data]
        theirs = [jax_jpegdct.parse_jpeg_dct(j) for j in data]
    else:
        ours = theirs = [np.asarray(Image.open(io.BytesIO(j)).convert("RGB"))
                         for j in data]
    got, dg = _stats_delta(jpegdct, lambda: jpegdct.pack_dct_batch(
        ours, 256, 320, use_native=native, wire_version=4))
    want, dw = _stats_delta(jax_jpegdct, lambda: jax_jpegdct.pack_dct_batch(
        theirs, 256, 320, use_native=native, wire_version=4))
    assert got["_wire"].shape == (5, jpegdct.wire_layout_v4(256, 320)["__total__"])
    np.testing.assert_array_equal(got["_wire"], want["_wire"])
    assert dg == dw and dg["truncated_coeffs"] > 0
    if kind != "array":
        assert (got["y_esc_idx"] >= 0).sum() > 0
    # the fused colour path writes Y in MCU order, the others in row order
    fused = kind == "bytes" and native
    assert got["h0w0"][:, 2].tolist() == ([1, 1, 1, 1, 0] if fused else [0] * 5)
    out = np.full_like(got["_wire"], 7)
    jpegdct.pack_dct_batch(ours, 256, 320, use_native=native, wire_version=4, out=out)
    np.testing.assert_array_equal(out, want["_wire"])


def _v4_wire(data=None):
    return jpegdct.pack_dct_batch(data or _jpegs(), 256, 320, wire_version=4)["_wire"]


def test_wire_fields_match_jax():
    w = _v4_wire()
    theirs = jax_ops.wire_fields(jnp.asarray(w), 256, 320, version=4)
    ours = ops.wire_fields(torch.from_numpy(w), 256, 320, version=4)
    assert ours.keys() == theirs.keys()
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy().astype(np.int64),
                                      np.asarray(theirs[k]).astype(np.int64), err_msg=k)
    assert ours["y_bm"].dtype == torch.int64 and int(ours["y_bm"].max()) >= 2**27
    assert int(ours["y_bm"].min()) >= 0


def test_popcount_and_stream_offsets():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64)
    x[:3] = (0, 2**32 - 1, 2**31)
    np.testing.assert_array_equal(ops._popcount32(torch.from_numpy(x.astype(np.int64))).numpy(),
                                  np.bitwise_count(x).astype(np.int64))
    pc = rng.integers(0, 5, (2, 4 * 6))
    pc_j = jnp.asarray(pc, jnp.int32)
    for order in (None, torch.tensor([0, 1])):
        got = ops._stream_offsets(torch.from_numpy(pc), 4, 6, order).numpy()
        for i in range(2):
            o = None if order is None else jnp.int32(int(order[i]))
            np.testing.assert_array_equal(got[i], np.asarray(jax_ops._stream_offsets(pc_j[i], 4, 6, o)))


def test_reconstruction_matches_jax():
    w = _v4_wire()
    theirs = jax_ops.wire_fields(jnp.asarray(w), 256, 320, version=4)
    ours = ops.wire_fields(torch.from_numpy(w), 256, 320, version=4)
    for p, nh, nw, z in (("y", 32, 40, jpegdct.Z_KEEP_Y), ("u", 16, 20, jpegdct.Z_KEEP_C),
                         ("v", 16, 20, jpegdct.Z_KEEP_C)):
        q = "q_y" if p == "y" else "q_c"
        order = ours["h0w0"][:, 2] if p == "y" else None
        got = ops.reconstruct_plane_sparse(ours[f"{p}_dc"], ours[f"{p}_bm"], ours[f"{p}_vals"],
                                           ours[f"{p}_esc_idx"], ours[f"{p}_esc_val"], ours[q],
                                           nbh=nh, nbw=nw, z=z, order=order)
        for i in range(4):
            want = jax_ops.reconstruct_plane_sparse(
                theirs[f"{p}_dc"][i], theirs[f"{p}_bm"][i], theirs[f"{p}_vals"][i],
                theirs[f"{p}_esc_idx"][i], theirs[f"{p}_esc_val"][i], theirs[q][i], nbh=nh, nbw=nw,
                z=z, order=None if order is None else theirs["h0w0"][i, 2])
            np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=1e-3, rtol=0)
    for dtype, jdtype, atol in ((torch.float32, jnp.float32, 2e-5), (torch.bfloat16, jnp.bfloat16, 2e-2)):
        got = ops.dct4_batch_to_normalized({"_wire": torch.from_numpy(w)}, 256, 320, dtype=dtype)
        want = np.asarray(jax_ops.dct4_batch_to_normalized({"_wire": jnp.asarray(w)}, 256, 320,
                                                           dtype=jdtype), np.float32)
        assert got.dtype == dtype and tuple(got.shape) == (4, 256, 320, 3)
        np.testing.assert_allclose(got.to(torch.float32).numpy(), want, atol=atol, rtol=0)


@pytest.mark.parametrize("case", ["colour", "colour padded", "grayscale", "two-pass", "escapes"])
def test_v4_reconstruction_is_v3s_where_nothing_was_cut(case):
    """The same coefficients through both wires give the same normalized
    RGB bit for bit (MCU-order and row-order Y streams)."""
    h0p, w0p = 128, 192
    if case == "colour":
        data = [encode(natural_image(128, 192, seed=s), quality=92) for s in range(3)]
    elif case == "colour padded":  # 5x7 MCUs of image in an 8x12-MCU canvas
        data = [encode(natural_image(80, 112, seed=21), quality=90)]
    elif case == "grayscale":
        data = [encode(natural_image(64, 64, seed=3, color=False)[..., 0], quality=90)]
    elif case == "two-pass":
        data = [jpegdct.parse_jpeg_dct(encode(natural_image(96, 128, seed=8), quality=85))]
    else:
        coef = np.zeros((8, 8, 64), np.int16)
        coef[0, 0, 0], coef[0, 0, 1], coef[2, 3, 5], coef[2, 3, 2] = 40, 300, -200, 7
        data = [jpegdct.DCTImage(64, 64, coef, None, None, np.ones(64, np.uint16), None)]
    stats, (w3, w4) = jpegdct.truncation_stats(), [
        jpegdct.pack_dct_batch(data, h0p, w0p, wire_version=v) for v in (3, 4)]
    assert jpegdct.truncation_stats() == stats  # nothing cut
    assert w4["_wire"].nbytes < 0.8 * w3["_wire"].nbytes
    if case == "escapes":
        assert (w4["y_esc_val"][0] != 0).sum() == 2
    if case == "colour padded":
        assert int(w4["h0w0"][0, 2]) == 1
    got = ops.dct4_batch_to_normalized({"_wire": torch.from_numpy(w4["_wire"])}, h0p, w0p)
    want = ops.dct_batch_to_normalized({"_wire": torch.from_numpy(w3["_wire"])}, h0p, w0p)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def dct4_detectors(params, stats, ec=EC):
    """(JAX detector, the port's) on the jpegdct4 wire, both folding the 2x stem."""
    jd = jax_eval.PyramidDetector(JaxDetector(stage_sizes=TINY), {"params": params, "batch_stats": stats},
                                  TEMPLATES, cfg=DetectorConfig(), ec=ec, transfer="jpegdct4")
    model = TinyFacesDetector(stage_sizes=TINY)
    model.load_state_dict(from_jax(params, stats))
    return jd, evaluation.PyramidDetector(model, TEMPLATES, DetectorConfig(), ec, device="cpu",
                                          transfer="jpegdct4")


@pytest.fixture(scope="module")
def pair():
    return dct4_detectors(*shared_weights())


def test_pyramid_matches_jax(pair):
    jd, td = pair
    data = jpegs()
    want = jd.detect_batch(data, prob_thresh=PROB, scales=SCALES)
    got = td.detect_batch(data, prob_thresh=PROB, scales=SCALES)
    assert sum(w.shape[0] for w in want) > 20
    for g, w in zip(got, want):
        assert_same_detections(g, w)
    packed = td.pack_inputs(data)
    assert packed.host.shape[1] == jpegdct.wire_layout_v4(192, 256)["__total__"]
    h0w0 = ops.wire_fields(packed.host, 192, 256, version=4)["h0w0"].numpy()
    np.testing.assert_array_equal(h0w0[:, :2], np.stack([packed.hs, packed.ws], 1))


def test_sweep_matches_jax(tmp_path):
    ann = _tree(tmp_path)
    jd, td = dct4_detectors(*shared_weights())
    ours = WIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    theirs = JaxWIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    assert_same_sweeps(td, ours, jd, theirs, tmp_path)


def test_service_takes_bytes(pair):
    _, td = pair
    reqs = jpegs(3) + jpegs(4)
    reqs[1] = jpegdct.parse_jpeg_dct(reqs[1])
    assert_service_matches_detect_batch(td, reqs)


def test_detect_image_feeds_jpeg_bytes(tmp_path):
    params, stats = shared_weights()
    data = jpegs(5)[2]
    path = tmp_path / "img.jpg"
    path.write_bytes(data)
    model = TinyFacesDetector(stage_sizes=TINY)
    model.load_state_dict(from_jax(params, stats))
    image = Image.open(path).convert("RGB")
    got = detect_image.run(model, image, TEMPLATES, PROB, 0.3, device="cpu", transfer="jpegdct4",
                           jpeg_bytes=data)
    want = jax_detect_image.run(JaxDetector(stage_sizes=TINY), {"params": params, "batch_stats": stats},
                                image, TEMPLATES, PROB, 0.3, transfer="jpegdct4", jpeg_bytes=data)
    assert want.shape[0] > 5
    assert_same_detections(got, np.asarray(want))
    out = tmp_path / "annotated.png"
    detect_image.main([str(path), "--device", "cpu", "--arch", "resnet50", "--prob_thresh", "0.5",
                       "--transfer", "jpegdct4", "--output", str(out)])
    assert Image.open(out).size == (200, 150)

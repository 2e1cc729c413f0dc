"""The port's pyramid, sweep, service and detect_image on the `jpegdct`
wire against the JAX package's, on the CPU.

Both detectors share the tiny model of tests/test_torch_evaluation.py and
see the same JPEG bytes (and DCTImage and uint8 inputs): identical
survivors, boxes within 1e-2 px, scores within 1e-3 (docs/PARITY.md). The
sweep over a JPEG tree writes the JAX sweep's result files at those
tolerances and wider_eval.py grades both to the same AP.
"""

import io
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import detect_image as jax_detect_image
import evaluate_model as jax_cli
import wider_eval
from tests.test_torch_evaluate_cli import _read_tree, _tree
from tests.test_torch_evaluation import (EC, PROB, SCALES, TEMPLATES, TINY, assert_same_detections,
                                         shared_weights)
from tests.test_torch_native import jax_native_library  # noqa: F401
from tests.torch_jpeg.make_fixtures import FIXTURE_DIR
from tinyfaces_tpu import evaluation as jax_eval
from tinyfaces_tpu.config import DetectorConfig, EvalConfig
from tinyfaces_tpu.data import WIDERFace as JaxWIDERFace
from tinyfaces_tpu.data import jpegdct as jax_jpegdct
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu_torch import detect_image
from tinyfaces_tpu_torch import evaluate_model as cli
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.data import WIDERFace, jpegdct
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.ops.jpeg import wire_fields
from tinyfaces_tpu_torch.serving import DetectionService
from tinyfaces_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


def _jpeg(img, quality=90, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality, **kw)
    return buf.getvalue()


def jpegs(seed: int = 0):
    """Noise JPEGs in two canvas buckets (128x192 and 192x256), q90."""
    rng = np.random.default_rng(seed)
    return [_jpeg(rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for h, w in ((100, 140), (90, 150), (150, 200))]


def dct_detectors(params, stats, ec=EC):
    """(JAX detector, the port's) on the jpegdct wire, one model's weights."""
    jd = jax_eval.PyramidDetector(JaxDetector(stage_sizes=TINY), {"params": params, "batch_stats": stats},
                                  TEMPLATES, cfg=DetectorConfig(),
                                  ec=EvalConfig(**{**ec.__dict__, "fold_stem": False}), transfer="jpegdct")
    model = TinyFacesDetector(stage_sizes=TINY)
    model.load_state_dict(from_jax(params, stats))
    return jd, evaluation.PyramidDetector(model, TEMPLATES, DetectorConfig(), ec, device="cpu",
                                          transfer="jpegdct")


@pytest.fixture(scope="module")
def pair():
    return dct_detectors(*shared_weights())


@pytest.mark.parametrize("inputs", ["bytes", "dct", "array", "mixed"])
def test_pyramid_matches_jax(pair, inputs):
    jd, td = pair
    data = theirs = jpegs()
    if inputs == "dct":
        data = [jpegdct.parse_jpeg_dct(d) for d in theirs]
        theirs = [jax_jpegdct.parse_jpeg_dct(d) for d in theirs]
    elif inputs == "array":
        data = theirs = [np.asarray(Image.open(io.BytesIO(d)).convert("RGB")) for d in data]
    elif inputs == "mixed":  # bytes that need the transcode, and a grayscale file
        data = theirs = [(FIXTURE_DIR / name).read_bytes()
                         for name in ("progressive_120x160_q85.jpg", "gray_240x320_q85.jpg")]
    want = jd.detect_batch(theirs, prob_thresh=PROB, scales=SCALES)
    got = td.detect_batch(data, prob_thresh=PROB, scales=SCALES)
    assert sum(w.shape[0] for w in want) > 20
    for g, w in zip(got, want):
        assert_same_detections(g, w)


def test_meta_sizes_equal_the_wire_and_one_upload(pair):
    _, td = pair
    packed = td.pack_inputs(jpegs(1))
    assert packed.host.dtype == torch.uint8 and packed.host.dim() == 2
    assert (packed.h0p, packed.w0p) == (192, 256)
    h0w0 = wire_fields(packed.host, packed.h0p, packed.w0p)["h0w0"].numpy()
    np.testing.assert_array_equal(h0w0, np.stack([packed.hs, packed.ws], 1))
    assert packed.host.shape[1] == jpegdct.wire_layout(192, 256)["__total__"]


def test_single_scale_and_host_resize_take_bytes(pair):
    jd, td = pair
    data = jpegs(2)[2]
    for kw in (dict(scales=(0,)), dict(scales=SCALES, host_resize=True)):
        want = jd.detect(data, prob_thresh=PROB, **kw)
        assert want.shape[0] > 5
        assert_same_detections(td.detect(data, prob_thresh=PROB, **kw), want)


def test_sweep_on_a_jpeg_tree_matches_jax_and_grades_the_same(tmp_path):
    ann = _tree(tmp_path)
    jd, td = dct_detectors(*shared_weights())
    ours = WIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    theirs = JaxWIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    # one file of the tree progressive: get_dct entropy-decodes it through the transcode
    prog = ours.image_path(1)
    Image.open(prog).save(prog, quality=90, progressive=True)
    assert isinstance(ours.get_dct(1)[0], jpegdct.DCTImage) and isinstance(ours.get_dct(0)[0], bytes)
    with pytest.raises(ValueError, match="host-resize"):
        cli.run(td, ours, PROB, 0.3, "val", results_dir=tmp_path / "x", host_resize=True)
    cli.run(td, ours, PROB, 0.3, "val", results_dir=tmp_path / "port", eval_batch=4, workers=2)
    jax_cli.run(jd, theirs, PROB, 0.3, "val", results_dir=tmp_path / "jax", eval_batch=4, workers=2)
    got, want = _read_tree(tmp_path / "port"), _read_tree(tmp_path / "jax")
    assert got.keys() == want.keys() and sum(int(v[1]) for v in want.values()) > 30
    for name in want:
        g, w = got[name], want[name]
        assert g[:2] == w[:2]
        if len(w) > 2:
            gv = np.array([r.split() for r in g[2:]], float)
            wv = np.array([r.split() for r in w[2:]], float)
            np.testing.assert_allclose(gv[:, :4], wv[:, :4], atol=1, rtol=0)  # rounded boxes
            np.testing.assert_allclose(gv[:, 4], wv[:, 4], atol=1e-3, rtol=0)
    res_p = wider_eval.read_results_dir(tmp_path / "port")
    res_j = wider_eval.read_results_dir(tmp_path / "jax")
    lines = []
    for name, rows in sorted(res_j.items()):
        lines += [name, str(min(2, len(rows)))]
        lines += [" ".join(str(int(v)) for v in r[:4]) + " 0 0 0 0 0 0" for r in rows[:2]]
        if not len(rows):
            lines.append("0 0 0 0 0 0 0 0 0 0")
    (tmp_path / "gt.txt").write_text("\n".join(lines) + "\n")
    gt, keeps = wider_eval.gt_from_txt(tmp_path / "gt.txt")
    aps = [(wider_eval.dataset_eval(res_p, gt, k), wider_eval.dataset_eval(res_j, gt, k))
           for k in keeps.values()]
    assert aps[0][1] > 0.1
    for a, b in aps:
        assert a == pytest.approx(b, abs=1e-6)


def test_service_takes_bytes(pair):
    _, td = pair
    reqs = jpegs(3) + jpegs(4)
    reqs[1] = jpegdct.parse_jpeg_dct(reqs[1])
    reqs[4] = np.asarray(Image.open(io.BytesIO(reqs[4])).convert("RGB"))
    want = [td.detect_batch([r], prob_thresh=PROB, scales=SCALES)[0] for r in reqs]
    assert sum(w.shape[0] for w in want) > 20
    svc = DetectionService(td, max_batch=4, max_delay_ms=20, prob_thresh=PROB, scales=SCALES)
    futures = [None] * len(reqs)

    def client(t):
        for i in range(t, len(reqs), 3):
            futures[i] = svc.submit(reqs[i])

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        got = [f.result(timeout=120) for f in futures]
    finally:
        svc.close()
    for g, w in zip(got, want):
        assert_same_detections(g, w)


def test_detect_image_feeds_jpeg_bytes(tmp_path):
    params, stats = shared_weights()
    data = jpegs(5)[2]
    path = tmp_path / "img.jpg"
    path.write_bytes(data)
    model = TinyFacesDetector(stage_sizes=TINY)
    model.load_state_dict(from_jax(params, stats))
    image = Image.open(path).convert("RGB")
    got = detect_image.run(model, image, TEMPLATES, PROB, 0.3, device="cpu", transfer="jpegdct",
                           jpeg_bytes=data)
    want = jax_detect_image.run(JaxDetector(stage_sizes=TINY), {"params": params, "batch_stats": stats},
                                image, TEMPLATES, PROB, 0.3, transfer="jpegdct", jpeg_bytes=data)
    assert want.shape[0] > 5
    assert_same_detections(got, np.asarray(want))
    out = tmp_path / "annotated.png"
    detect_image.main([str(path), "--device", "cpu", "--arch", "resnet50", "--prob_thresh", "0.5",
                       "--transfer", "jpegdct", "--output", str(out)])
    assert Image.open(out).size == (200, 150)
    # the other wires run too (held to JAX in tests/test_torch_{yuv420,jpegdct4}.py)
    for transfer in ("yuv420", "jpegdct4"):
        dets = detect_image.run(model, image, TEMPLATES, PROB, 0.3, device="cpu", transfer=transfer,
                                jpeg_bytes=data)
        assert dets.shape[1] == 5 and dets.shape[0] > 5 and np.isfinite(dets).all()

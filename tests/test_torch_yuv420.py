"""The `yuv420` wire of the port against the JAX package's, on the CPU.

Host half: `rgb_to_yuv420` is byte-equal to PIL's convert("YCbCr") on all
2^24 RGB triples (one 4096x4096 image) and to the JAX package's function
(which calls PIL) on random batches. Device half: `yuv420_to_normalized`
within 1e-6 of the JAX function in fp32, and within bf16's resolution in
bf16. Training: build_targets on a yuv batch, both loaders' pack="yuv420"
bit-equal to the JAX loaders', one train step within rtol 1e-4, the CLI's
`--transfer yuv420`. Inference: the pyramid, the sweep, the service and
detect_image against the JAX package's on yuv420: the same survivors,
boxes within 1e-2 px, scores within 1e-3.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import detect_image as jax_detect_image
import evaluate_model as jax_cli
from tests.test_torch_evaluate_cli import _read_tree, _tree
from tests.test_torch_evaluation import (EC, PROB, SCALES, TEMPLATES, TINY, assert_same_detections,
                                         images, shared_weights)
from tests.test_torch_main import FACES, SIZES, _argv, _run
from tests.test_torch_native import _assert_same, _datasets
from tests.test_torch_trainer import TC, TINY_STAGES, _step_draws
from tests.test_torch_wider_train import CFG, JAX_CFG, write_train_tree
from tinyfaces_tpu import evaluation as jax_eval
from tinyfaces_tpu.config import DetectorConfig
from tinyfaces_tpu.data import WIDERFace as JaxWIDERFace
from tinyfaces_tpu.data import loader as jax_loader
from tinyfaces_tpu.data import targets as jax_targets
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.trainer import create_train_state
from tinyfaces_tpu.trainer import make_optimizer as jax_make_optimizer
from tinyfaces_tpu.trainer import make_train_step as jax_make_train_step
from tinyfaces_tpu_torch import detect_image
from tinyfaces_tpu_torch import evaluate_model as cli
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.data import WIDERFace, load_templates, loader, native
from tinyfaces_tpu_torch.data import targets
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.serving import DetectionService
from tinyfaces_tpu_torch.trainer import make_lr_schedule, make_optimizer, train_step
from tinyfaces_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


def test_rgb_to_yuv420_is_pil_on_every_rgb_triple():
    idx = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([idx >> 16, (idx >> 8) & 255, idx & 255], -1).astype(np.uint8).reshape(4096, 4096, 3)
    del idx
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    for c, plane in enumerate(targets._pil_ycbcr(rgb)):
        np.testing.assert_array_equal(plane, ycc[..., c])
    y, u, v = targets.rgb_to_yuv420(rgb[None])
    np.testing.assert_array_equal(y[0], ycc[..., 0])
    for got, c in ((u, 1), (v, 2)):
        want = (ycc[..., c].reshape(2048, 2, 2048, 2).mean((1, 3)) + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("shape", [(3, 64, 96), (1, 2, 2), (2, 130, 18)])
def test_rgb_to_yuv420_matches_jax(shape):
    rgb = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    got = targets.rgb_to_yuv420(rgb)
    want = jax_targets.rgb_to_yuv420(rgb)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, w)
    out = tuple(np.empty_like(w) for w in want)
    assert targets.rgb_to_yuv420(rgb, out) is out
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="even"):
        targets.rgb_to_yuv420(rgb[:, :1])


def _planes(seed=0, b=2, h=48, w=64):
    return jax_targets.rgb_to_yuv420(
        np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), dtype=np.uint8))


def test_yuv420_to_normalized_matches_jax():
    y, u, v = _planes()
    want = np.asarray(jax_targets.yuv420_to_normalized(*map(jnp.asarray, (y, u, v))))
    got = targets.yuv420_to_normalized(*map(torch.from_numpy, (y, u, v)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # in bf16 the conversion itself runs in bf16, as in the JAX package
    wbf = np.asarray(jax.jit(lambda a, b, c: jax_targets.yuv420_to_normalized(
        a, b, c, dtype=jnp.bfloat16))(y, u, v), np.float32)
    gbf = targets.yuv420_to_normalized(*map(torch.from_numpy, (y, u, v)), dtype=torch.bfloat16)
    assert gbf.dtype == torch.bfloat16
    np.testing.assert_allclose(gbf.float().numpy(), wbf, atol=0.05, rtol=0)
    assert np.abs(gbf.float().numpy() - want).max() > 1e-3  # bf16 really ran


def test_build_targets_on_a_yuv_batch():
    rng = np.random.default_rng(3)
    item = {"gt_boxes": np.array([[10, 12, 60, 70], [0, 0, 0, 0]], np.float32),
            "gt_valid": np.array([True, False]), "paste_box": np.array([0, 0, 128, 128], np.float32),
            "flip": False}
    rgb = rng.integers(0, 256, (2, 128, 128, 3), dtype=np.uint8)
    y, u, v = targets.rgb_to_yuv420(rgb)
    batch = {k: torch.from_numpy(np.stack([item[k]] * 2)) for k in item}
    yuv = {**batch, "image_y": torch.from_numpy(y), "image_u": torch.from_numpy(u),
           "image_v": torch.from_numpy(v)}
    tmpl = torch.tensor(load_templates(), dtype=torch.float32)
    cfg = DetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=2)
    images_y, cls_y, reg_y = targets.build_targets(yuv, tmpl, torch.Generator().manual_seed(0), cfg)
    _, cls_r, reg_r = targets.build_targets({**batch, "image": torch.from_numpy(rgb)}, tmpl,
                                            torch.Generator().manual_seed(0), cfg)
    want = np.asarray(jax_targets.yuv420_to_normalized(*map(jnp.asarray, (y, u, v))))
    np.testing.assert_allclose(images_y.numpy(), want, atol=1e-6, rtol=0)
    torch.testing.assert_close(cls_y, cls_r, rtol=0, atol=0)
    torch.testing.assert_close(reg_y, reg_r, rtol=0, atol=0)
    assert (cls_y == 1).sum() > 0


def _first_yuv_batches(root, engine):
    ours, theirs = _datasets(root)
    cls, jax_cls = ((loader.NativePrefetchLoader, jax_loader.NativePrefetchLoader) if engine == "native"
                    else (loader.PrefetchLoader, jax_loader.PrefetchLoader))
    got = next(iter(cls(ours, 2, device="cpu", workers=2, seed=5, epoch=1, pack="yuv420")))
    want = next(iter(jax_cls(theirs, 2, workers=2, seed=5, epoch=1, pack="yuv420")))
    return got, want


@pytest.mark.parametrize("engine", ["native", "python"])
def test_first_batch_matches_jax_loader(tmp_path, engine):
    samples = native.counters["samples"]
    got, want = _first_yuv_batches(tmp_path, engine)
    assert "image" not in got and got["image_y"].shape == (2, *CFG.input_size)
    assert got["image_u"].shape == (2, CFG.input_size[0] // 2, CFG.input_size[1] // 2)
    _assert_same(got, want)
    assert (native.counters["samples"] > samples) == (engine == "native")


def test_one_step_from_a_yuv_batch_matches_jax(tmp_path):
    got, want = _first_yuv_batches(tmp_path, "native")
    templates = load_templates()
    jmodel = JaxDetector(stage_sizes=TINY_STAGES)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(2), CFG.input_size))
    tx = jax_make_optimizer(TC, steps_per_epoch=10)
    key = jax.random.PRNGKey(4)
    jstate, jlb = jax_make_train_step(jmodel, tx, JAX_CFG, templates)(
        create_train_state(jmodel, params, stats, tx), {k: jnp.asarray(v) for k, v in want.items()}, key)
    model = TinyFacesDetector(stage_sizes=TINY_STAGES)
    model.load_state_dict(from_jax(params, stats))
    lb = train_step(model, make_optimizer(model, TC), got, None, cfg=CFG,
                    templates=torch.tensor(templates, dtype=torch.float32),
                    lr=make_lr_schedule(TC, 10)(0), draws=_step_draws(key, 0, 2))
    for a, b in zip(lb, jlb):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-4)


def test_cli_trains_on_the_yuv420_wire(tmp_path, monkeypatch):
    tree = write_train_tree(tmp_path / "data", sizes=SIZES, faces=FACES)
    samples = native.counters["samples"]
    trainer, run_dir = _run(tmp_path, monkeypatch, "yuv",
                            _argv(tree, "--transfer", "yuv420", "--epochs", "2", "--save-every", "2"))
    assert trainer.transfer == "yuv420" and trainer.step == 4 and trainer.skipped_steps == 0
    assert np.isfinite(trainer.class_average.average) and np.isfinite(trainer.reg_average.average)
    assert native.counters["samples"] - samples == 8  # augmented by the C++ engine, then packed
    assert (run_dir / "weights" / "checkpoint_2").is_file()


def yuv_detectors(params, stats, ec=EC):
    """(JAX detector, the port's) on the yuv420 wire, both folding the 2x stem."""
    jd = jax_eval.PyramidDetector(JaxDetector(stage_sizes=TINY), {"params": params, "batch_stats": stats},
                                  TEMPLATES, cfg=DetectorConfig(), ec=ec, transfer="yuv420")
    model = TinyFacesDetector(stage_sizes=TINY)
    model.load_state_dict(from_jax(params, stats))
    return jd, evaluation.PyramidDetector(model, TEMPLATES, DetectorConfig(), ec, device="cpu",
                                          transfer="yuv420")


@pytest.fixture(scope="module")
def pair():
    return yuv_detectors(*shared_weights())


def test_pyramid_matches_jax(pair):
    jd, td = pair
    imgs = images()
    want = jd.detect_batch(imgs, prob_thresh=PROB, scales=SCALES)
    got = td.detect_batch(imgs, prob_thresh=PROB, scales=SCALES)
    assert sum(w.shape[0] for w in want) > 20
    for g, w in zip(got, want):
        assert_same_detections(g, w)


def test_one_upload_of_the_planes(pair):
    _, td = pair
    imgs = images(1)
    packed = td.pack_inputs(imgs)
    assert packed.host.dtype == torch.uint8 and tuple(packed.host.shape) == (3, 192 * 256 * 3 // 2)
    canvas = np.stack([np.pad(im, ((0, 192 - im.shape[0]), (0, 256 - im.shape[1]), (0, 0)))
                       for im in imgs])
    for i, im in enumerate(imgs):
        canvas[i, im.shape[0]:] = canvas[i, :, im.shape[1]:] = evaluation.MEAN_PIXEL
    for got, want in zip(evaluation.yuv420_wire(packed.host, 192, 256), jax_targets.rgb_to_yuv420(canvas)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_sweep_matches_jax(tmp_path):
    ann = _tree(tmp_path)
    jd, td = yuv_detectors(*shared_weights())
    ours = WIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    theirs = JaxWIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    assert_same_sweeps(td, ours, jd, theirs, tmp_path)


def assert_same_sweeps(td, ours, jd, theirs, tmp_path):
    """The port's sweep (evaluate_model.run) and the JAX package's write the
    same result files: equal headers, rounded boxes within 1 px, scores
    within 1e-3."""
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


def test_service_matches_detect_batch(pair):
    _, td = pair
    assert_service_matches_detect_batch(td, images(3) + images(4))


def assert_service_matches_detect_batch(td, reqs):
    """DetectionService answering `reqs` from 3 threads gives each request's
    detect_batch result."""
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


def test_detect_image_matches_jax(tmp_path):
    params, stats = shared_weights()
    path = tmp_path / "img.png"
    Image.fromarray(images(5)[2]).save(path)
    model = TinyFacesDetector(stage_sizes=TINY)
    model.load_state_dict(from_jax(params, stats))
    image = Image.open(path).convert("RGB")
    got = detect_image.run(model, image, TEMPLATES, PROB, 0.3, device="cpu", transfer="yuv420")
    want = jax_detect_image.run(JaxDetector(stage_sizes=TINY), {"params": params, "batch_stats": stats},
                                image, TEMPLATES, PROB, 0.3, transfer="yuv420")
    assert want.shape[0] > 5
    assert_same_detections(got, np.asarray(want))
    out = tmp_path / "annotated.png"
    detect_image.main([str(path), "--device", "cpu", "--arch", "resnet50", "--prob_thresh", "0.5",
                       "--transfer", "yuv420", "--output", str(out)])
    assert Image.open(out).size == (200, 150)

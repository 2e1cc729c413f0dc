"""The port's pyramid inference against the JAX package on the CPU.

Both detectors share one tiny model's weights (stages (1, 1, 1); JAX init,
class-head biases shifted by -2 so the candidates spread out), carried over
with utils/convert.from_jax, and see the same images: 3 images in 2 canvas
buckets, scales (-1, 0, 1), fp32, EvalConfig(max_dets_per_scale=50,
max_total_dets=50). Tolerances (docs/PARITY.md composition level): against
JAX with fold_stem=False the survivor sets are identical, boxes within
1e-2 px and scores within 1e-3. Against JAX's default folded 2x stem,
which differs only in summation order, the same tolerances hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import evaluate_model as jax_cli
from tinyfaces_tpu import evaluation as jax_eval
from tinyfaces_tpu.config import DetectorConfig, EvalConfig
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu_torch import evaluate_model as cli
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.trainer import save_checkpoint
from tinyfaces_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)

TINY = (1, 1, 1)
TEMPLATES = load_templates()
EC = EvalConfig(max_dets_per_scale=50, max_total_dets=50)
SCALES = (-1, 0, 1)
PROB = 0.02


_jax_init = jax.jit(lambda key: JaxDetector(stage_sizes=TINY).init(
    key, jnp.zeros((1, 64, 64, 3)), train=False))


def shared_weights(seed: int = 0):
    """numpy (params, batch_stats) of the tiny JAX model, class biases -2."""
    variables = jax.device_get(_jax_init(jax.random.PRNGKey(seed)))
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = variables["batch_stats"]
    for head in ("score_res3", "score_res4"):
        params[head]["bias"][:25] -= 2.0
    return params, jax.tree_util.tree_map(np.array, stats)


def detectors(params, stats, ec=EC, dtype=torch.float32):
    """(JAX detector with fold_stem=False, the port's detector on the CPU)."""
    jd = jax_eval.PyramidDetector(JaxDetector(stage_sizes=TINY),
                                  {"params": params, "batch_stats": stats}, TEMPLATES,
                                  cfg=DetectorConfig(), ec=ec.__class__(**{**ec.__dict__,
                                                                            "fold_stem": False}))
    model = TinyFacesDetector(stage_sizes=TINY, dtype=dtype)
    model.load_state_dict(from_jax(params, stats))
    return jd, evaluation.PyramidDetector(model, TEMPLATES, DetectorConfig(), ec, device="cpu")


def images(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for h, w in ((100, 140), (90, 150), (150, 200))]  # buckets 128x192, 192x256


def assert_same_detections(got, want, box_atol=1e-2, score_atol=1e-3):
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=box_atol, rtol=0)
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=score_atol, rtol=0)


@pytest.fixture(scope="module")
def pair():
    return detectors(*shared_weights())


def test_level_sizes_and_buckets_match_jax():
    cases = [(95, 117), (768, 1024), (2073, 8105), (8105, 2073), (4999, 9973), (1, 7), (31, 31)]
    h = np.array([c[0] for c in cases])
    w = np.array([c[1] for c in cases])
    for sexp in (-2, -1, 0, 1):
        th, tw = evaluation.pyramid_level_sizes(torch.from_numpy(h), torch.from_numpy(w), sexp)
        jth, jtw = jax_eval.pyramid_level_sizes(jnp.asarray(h, jnp.int32), jnp.asarray(w, jnp.int32),
                                                sexp)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jth))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jtw))
    for factor in (0.25, 2**-0.5, 1.0, 2**0.5, 2.0, 0.3):
        np.testing.assert_array_equal(evaluation.pyramid_level_sizes_np(h, w, factor),
                                      jax_eval.pyramid_level_sizes_np(h, w, factor))
    xs = list(range(1, 3000, 7)) + [8105, 9973]
    assert [evaluation._round_up(x) for x in xs] == [jax_eval._round_up(x) for x in xs]
    rng = np.random.default_rng(0)
    sizes = [(int(rng.integers(1, 2100)), int(rng.integers(1, 2100))) for _ in range(300)]
    for eval_batch in (1, 8, 32):
        assert cli.bucket_plan(sizes, eval_batch) == jax_cli.bucket_plan(sizes, eval_batch)


@pytest.mark.parametrize("scales", [SCALES, (-0.5, 0.5)])
def test_detect_batch_matches_jax(pair, scales):
    jd, td = pair
    imgs = images()
    want = jd.detect_batch(imgs, prob_thresh=PROB, scales=scales)
    got = td.detect_batch(imgs, prob_thresh=PROB, scales=scales)
    assert sum(w.shape[0] for w in want) > 20
    for g, w in zip(got, want):
        assert_same_detections(g, w)


def test_detect_matches_jax_default_folded_stem(pair):
    _, td = pair
    params, stats = shared_weights()
    jd = jax_eval.PyramidDetector(JaxDetector(stage_sizes=TINY),
                                  {"params": params, "batch_stats": stats}, TEMPLATES,
                                  cfg=DetectorConfig(), ec=EC)
    assert jd.ec.fold_stem
    img = images(1)[2]
    want = jd.detect(img, prob_thresh=PROB, scales=SCALES)
    assert want.shape[0] > 10
    assert_same_detections(td.detect(img, prob_thresh=PROB, scales=SCALES), want)


def test_host_resize_matches_jax(pair):
    jd, td = pair
    img = images(2)[0]
    want = jd.detect(img, prob_thresh=PROB, scales=SCALES, host_resize=True)
    assert want.shape[0] > 10
    assert_same_detections(td.detect(img, prob_thresh=PROB, scales=SCALES, host_resize=True), want)


def test_write_results_byte_identical(pair, tmp_path):
    jd, td = pair
    img = images(3)[1]
    got = td.detect(img, prob_thresh=PROB, scales=SCALES)
    extra = np.array([[10.2, 20.7, 50.4, 80.1, 0.93], [5.0, 5.0, np.inf, 25.0, 0.5],
                      [1.0, np.nan, 9.0, 9.0, 0.4], [-3.5, 2.5, 7.5, 9.49, -1.25]], np.float32)
    for i, dets in enumerate((got, jd.detect(img, prob_thresh=PROB, scales=SCALES), extra,
                              np.zeros((0, 5), np.float32))):
        name = f"0--Parade/img_{i}.jpg"
        a = evaluation.write_results(dets, name, "val", tmp_path / "port")
        b = jax_eval.write_results(dets, name, "val", tmp_path / "jax")
        assert a.read_bytes() == b.read_bytes()
        assert a.relative_to(tmp_path / "port") == b.relative_to(tmp_path / "jax")


def test_bf16_head_outputs_match_jax():
    """Raw head outputs at dtype=bfloat16 (fp32 parameters and BN
    statistics) within 3% of the output scale: bf16 has an 8-bit mantissa
    and the two sides round at different points (XLA fuses elementwise
    chains in f32 on the CPU)."""
    params, stats = shared_weights(1)
    x = np.random.default_rng(5).normal(0, 1, (2, 96, 128, 3)).astype(np.float32)
    apply = jax.jit(JaxDetector(stage_sizes=TINY, dtype=jnp.bfloat16).apply)
    want = np.asarray(apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = TinyFacesDetector(stage_sizes=TINY, dtype=torch.bfloat16).eval()
    model.load_state_dict(from_jax(params, stats))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert all(p.dtype == torch.float32 for p in model.state_dict().values())
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max()
    assert err <= 0.03 * scale, (err, scale)
    fp32 = TinyFacesDetector(stage_sizes=TINY).eval()
    fp32.load_state_dict(from_jax(params, stats))
    with torch.no_grad():
        assert (fp32(torch.from_numpy(x)) - got).abs().max() > 1e-3 * scale  # bf16 really ran


def test_bf16_pyramid_runs_and_stays_close(pair):
    jd, _ = pair
    _, td = detectors(*shared_weights(), dtype=torch.bfloat16)
    img = images(4)[0]
    got = td.detect(img, prob_thresh=PROB, scales=SCALES)
    want = jd.detect(img, prob_thresh=PROB, scales=SCALES)
    assert got.dtype == np.float32 and got.shape[1] == 5 and np.isfinite(got).all()
    assert abs(got.shape[0] - want.shape[0]) <= max(3, want.shape[0] // 5)


def test_unported_options_raise():
    model = TinyFacesDetector(stage_sizes=TINY)
    assert evaluation.PyramidDetector(model, TEMPLATES, device="cpu", transfer="jpegdct").transfer \
        == "jpegdct"  # ported in tests/test_torch_jpegdct_eval.py
    assert evaluation.PyramidDetector(model, TEMPLATES, ec=EvalConfig(resample="pil"),
                                      device="cpu").ec.resample == "pil"  # tests/test_torch_pilresize.py
    for kw, item in ((dict(transfer="yuv420"), "item 15"),
                     (dict(transfer="jpegdct4"), "item 15"), (dict(mesh=object()), "item 13"),
                     (dict(shard="spatial"), "item 13"),
                     (dict(ec=EvalConfig(resample="pil"), transfer="jpegdct"), "transfer='rgb'"),
                     (dict(ec=EvalConfig(resample="nearest")), "resample")):
        with pytest.raises(ValueError, match=item):
            evaluation.PyramidDetector(model, TEMPLATES, device="cpu", **kw)
    with pytest.raises(ValueError, match="orbax"):
        evaluation.load_weights(evaluation.Path(evaluation.__file__).parent)


def test_load_weights_from_every_format(tmp_path):
    from tinyfaces_tpu.utils.serialization import save_npz

    params, stats = shared_weights(2)
    sd = from_jax(params, stats)
    save_npz(tmp_path / "w.npz", {"params": params, "batch_stats": stats})

    model = TinyFacesDetector(stage_sizes=TINY)
    model.load_state_dict(sd)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    port_ckpt = save_checkpoint(model, opt, step=3, epoch=0, batch_size=2, save_path=tmp_path)

    # reference DetectionModel layout: dense (C, C, 4, 4) diagonal upsample
    ref = {k: v.clone() for k, v in sd.items()}
    up = ref.pop("score4_upsample.weight")[:, 0]
    dense = torch.zeros(125, 125, 4, 4)
    dense[torch.arange(125), torch.arange(125)] = up
    ref["score4_upsample.weight"] = dense
    ref["model.bn1.num_batches_tracked"] = torch.tensor(7)
    torch.save({"model": ref, "epoch": 3}, tmp_path / "ref.pth")

    for path in (tmp_path / "w.npz", port_ckpt, tmp_path / "ref.pth"):
        loaded = evaluation.load_weights(path)
        assert loaded.keys() == sd.keys()
        for k in sd:
            torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0)
    m = evaluation.get_model(None, arch="resnet50", device="cpu")
    assert m.stage_sizes == (3, 4, 6) and not m.training

"""Spatial partitioning (parallel/spatial.py) against the JAX package's on
the CPU.

The port splits one image's rows over a device list, here `["cpu"] * 8`
(the same halo code as over cards, with same-device copies); the JAX
package shards the same axis over the 8-device CPU mesh of tests/conftest.py
and lets GSPMD insert the halos. Tolerances are tests/test_parallel.py's:
the forward within atol 1e-5 of JAX's spatial forward, and the pyramid's
detections within rtol 1e-4 / atol 1e-3 of JAX's spatially sharded
pyramid (random-init weights regress some box coordinates to large values,
where only a relative tolerance means anything). Halo ops are also held at
their slice borders against the unsharded op exactly as computed on one
tensor (atol 1e-6), and the CLI's result files against its unsharded run's
at tests/test_torch_evaluate_cli.py's tolerances.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import PartitionSpec as P

import evaluate_model as jax_cli
from tests.test_torch_evaluate_cli import _read_tree, _tree
from tests.test_torch_evaluation import EC, PROB, TEMPLATES, TINY, shared_weights
from tinyfaces_tpu import evaluation as jax_eval
from tinyfaces_tpu.config import DetectorConfig as JaxDetectorConfig
from tinyfaces_tpu.config import EvalConfig as JaxEvalConfig
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.parallel.mesh import make_mesh
from tinyfaces_tpu.parallel.spatial import choose_eval_sharding, spatial_forward_fn
from tinyfaces_tpu_torch import evaluate_model as cli
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.parallel import spatial
from tinyfaces_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)

CPU8 = ["cpu"] * 8


def _port_model(params, stats, dtype=None):
    model = TinyFacesDetector(stage_sizes=TINY, dtype=dtype)
    model.load_state_dict(from_jax(params, stats))
    return model.eval()


def test_spatial_forward_matches_jax_spatial_forward():
    """tests/test_parallel.py's case: (1, 1, 1) stages, a 64x64 input over 8
    devices (4 res4 rows, so half the slices are empty)."""
    jmodel = JaxDetector(stage_sizes=TINY)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(0), (64, 64)))
    x = np.random.default_rng(0).standard_normal((1, 64, 64, 3)).astype(np.float32)
    mesh = make_mesh(jax.devices()[:8])
    want = np.asarray(spatial_forward_fn(jmodel, mesh)({"params": params, "batch_stats": stats},
                                                       x))
    model = _port_model(params, stats)
    got = spatial.spatial_forward([model] * 8, torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), model(torch.from_numpy(x)).numpy(), atol=1e-5)


@pytest.mark.parametrize("hw,n", [((96, 128), 8), ((100, 72), 3), ((32, 48), 8), ((160, 96), 2)])
@pytest.mark.parametrize("stem_precomputed", [False, True])
def test_uneven_splits_equal_the_unsharded_forward(hw, n, stem_precomputed):
    """More slices than res4 rows (32x48: 2 rows over 8), a height that is
    not a multiple of 16 (100) and two slices; from the image or from
    conv1's output (the folded stem's entry)."""
    model = init_model(TinyFacesDetector(stage_sizes=TINY), torch.Generator().manual_seed(1)).eval()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 3, *hw)).astype(np.float32))
    with torch.no_grad():
        if stem_precomputed:
            x = model.model.conv1(x)
        want = model(x if stem_precomputed else x.permute(0, 2, 3, 1),
                     stem_precomputed=stem_precomputed)
    got = spatial.spatial_forward([model] * n, x, stem_precomputed=stem_precomputed)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_split_is_exact_in_float64():
    """In float64 the split forward equals the unsplit one to summation
    order (atol 1e-10): the halos feed every op the rows it reads
    unsplit, whatever cuDNN or oneDNN picks per slice shape."""
    model = init_model(TinyFacesDetector(stage_sizes=(2, 2, 2)), torch.Generator().manual_seed(2))
    model = model.double().eval()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((1, 3, 112, 80)))
    with torch.no_grad():
        want = model(x.permute(0, 2, 3, 1))
    got = spatial.spatial_forward([model] * 5, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-10)


def test_slice_bounds():
    assert spatial.slice_bounds(64, 2) == [(0, 32), (32, 64)]
    assert spatial.slice_bounds(100, 3) == [(0, 32), (32, 64), (64, 100)]
    assert spatial.slice_bounds(32, 8) == [(0, 0), (0, 0), (0, 0), (0, 16), (16, 16), (16, 16),
                                           (16, 16), (16, 32)]
    assert spatial.slice_bounds(8, 8, align=8)[-1] == (0, 8)


def test_max_pool_border_is_minus_inf():
    """All-negative activations: a zero pad would win the max at the image's
    top and bottom rows; every slice pads -inf there as F.max_pool2d does,
    and reads its neighbours' rows at interior borders."""
    x = -1.0 - torch.rand(2, 4, 24, 10, generator=torch.Generator().manual_seed(0))
    walk = spatial._Walk([TinyFacesDetector(stage_sizes=TINY)] * 3)
    got = spatial.gather(walk.max_pool(spatial.scatter(x, walk.devices, align=8)), "cpu")
    want = F.max_pool2d(x, 3, 2, padding=1)
    assert (want < 0).all() and torch.equal(got, want)


@pytest.mark.parametrize("h3", [9, 10])
def test_transpose_conv_and_crop_at_slice_borders(h3):
    """The k4/s2/p1 upsample writes rows [2a, 2b) of each slice from its
    input rows [a-1, b+1); an odd res3 height crops the bottom slice's last
    row only."""
    model = TinyFacesDetector(stage_sizes=TINY)
    h4 = (h3 + 1) // 2
    s4 = torch.randn(1, 125, h4, 7, generator=torch.Generator().manual_seed(3))
    walk = spatial._Walk([model] * 3)
    rows = spatial.scatter(s4, walk.devices, align=2)
    up = walk.upsample(rows, "score4_upsample")
    got = spatial.gather(up, "cpu")[:, :, :h3, :13]
    with torch.no_grad():
        want = model.score4_upsample(s4)[:, :, :h3, :13]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert [b - a for a, b in up.bounds] == [2 * (b - a) for a, b in rows.bounds]


def test_choose_mode_matches_choose_eval_sharding():
    mesh = make_mesh(jax.devices()[:8])
    spec = {"batch": P("data"), "spatial": P(None, "data")}
    for batch in (1, 7, 8, 16):
        for mode in ("batch", "spatial", "auto"):
            assert spec[spatial.choose_mode(8, batch, mode)] == \
                choose_eval_sharding(mesh, batch, mode).spec
    for fn in (lambda: spatial.choose_mode(8, 1, "rows"),
               lambda: choose_eval_sharding(mesh, 1, "rows")):
        with pytest.raises(ValueError, match="unknown eval sharding mode"):
            fn()


_JAX_DETECTORS: dict = {}


def _jax_spatial(params, stats, fold: bool):
    if fold not in _JAX_DETECTORS:
        _JAX_DETECTORS[fold] = jax_eval.PyramidDetector(
            JaxDetector(stage_sizes=TINY), {"params": params, "batch_stats": stats}, TEMPLATES,
            cfg=JaxDetectorConfig(), ec=JaxEvalConfig(**{**EC.__dict__, "fold_stem": fold}),
            mesh=make_mesh(jax.devices()[:8]), shard="spatial")
    return _JAX_DETECTORS[fold]


@pytest.mark.parametrize("scales", [(0,), (-2, -1, 0, 1)])
@pytest.mark.parametrize("fold", [True, False])
def test_pyramid_spatial_matches_jax(scales, fold):
    """tests/test_parallel.py's 96x128 image through both spatially sharded
    pyramids (8 slices; the -2 level has 2 res4 rows), the 2x level with the
    folded stem and without it."""
    params, stats = shared_weights()
    img = np.random.default_rng(3).integers(0, 255, (96, 128, 3), dtype=np.uint8)
    ec = EvalConfig(**{**EC.__dict__, "fold_stem": fold})
    det = evaluation.PyramidDetector(_port_model(params, stats), TEMPLATES, DetectorConfig(), ec,
                                     device=CPU8, shard="spatial")
    base = evaluation.PyramidDetector(_port_model(params, stats), TEMPLATES, DetectorConfig(), ec,
                                      device="cpu")
    kw = dict(prob_thresh=PROB, nms_thresh=0.3, scales=scales)
    got = det.detect(img, **kw)
    want = _jax_spatial(params, stats, fold).detect(img, **kw)
    unsharded = base.detect(img, **kw)
    assert got.shape == want.shape == unsharded.shape and got.shape[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, unsharded, rtol=1e-4, atol=1e-3)


def test_auto_mode_and_repeated_devices():
    """"auto" splits rows for a batch smaller than the device count and
    batches otherwise, over a repeated device."""
    params, stats = shared_weights()
    model = _port_model(params, stats)
    det = evaluation.PyramidDetector(model, TEMPLATES, DetectorConfig(), EC, device=["cpu"] * 2,
                                     shard="auto")
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 255, (64, 80, 3), dtype=np.uint8) for _ in range(2)]
    base = evaluation.PyramidDetector(_port_model(params, stats), TEMPLATES, DetectorConfig(), EC,
                                      device="cpu")
    for batch in (imgs[:1], imgs):  # spatial, then batch
        for g, w in zip(det.detect_batch(batch, PROB, scales=(0, 1)),
                        base.detect_batch(batch, PROB, scales=(0, 1))):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
    with pytest.raises(ValueError, match="unknown shard mode"):
        evaluation.PyramidDetector(model, TEMPLATES, device="cpu", shard="rows")


def test_cli_refusals_and_result_files(tmp_path, monkeypatch):
    """--shard spatial|auto need --data-parallel (the JAX CLI's message);
    batch divisibility binds only under batch sharding; the spatial sweep
    over 4 devices writes the unsharded sweep's files (same files and
    counts, boxes within 1 px of rounding, scores within 1e-3)."""
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):  # --fp32 sets them
        monkeypatch.setattr(flags, "allow_tf32", flags.allow_tf32)
    ann = _tree(tmp_path)
    for shard in ("spatial", "auto"):
        with pytest.raises(SystemExit, match=f"--shard {shard} requires --data-parallel"):
            cli.main([str(ann), "--device", "cpu", "--shard", shard])
        jax_args = jax_cli.arguments([str(ann), "--shard", shard])
        assert jax_args.shard == shard and not jax_args.data_parallel
    params, stats = shared_weights()
    monkeypatch.setattr(cli, "get_model", lambda *a, **kw: _port_model(params, stats))
    monkeypatch.setattr(cli, "local_devices", lambda device: [torch.device("cpu")] * 4)
    with pytest.raises(SystemExit, match="divisible by the 4 devices"):
        cli.main([str(ann), "--device", "cpu", "--data-parallel", "--eval-batch", "3"])
    common = [str(ann), "--dataset-root", str(tmp_path), "--device", "cpu", "--fp32",
              "--transfer", "rgb", "--eval-batch", "3", "--workers", "2",
              "--prob_thresh", str(PROB)]
    cli.main(common + ["--data-parallel", "--shard", "spatial",
                       "--results_dir", str(tmp_path / "spatial")])
    cli.main(common + ["--results_dir", str(tmp_path / "plain")])
    got, want = _read_tree(tmp_path / "spatial"), _read_tree(tmp_path / "plain")
    assert got.keys() == want.keys() and sum(int(v[1]) for v in want.values()) > 0
    for name in want:
        g, w = got[name], want[name]
        assert g[:2] == w[:2]
        if len(w) > 2:
            gv = np.array([r.split() for r in g[2:]], float)
            wv = np.array([r.split() for r in w[2:]], float)
            np.testing.assert_allclose(gv[:, :4], wv[:, :4], atol=1, rtol=0)
            np.testing.assert_allclose(gv[:, 4], wv[:, 4], atol=1e-3, rtol=0)

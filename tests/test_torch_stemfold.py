"""The port's folded 2x stem (ops/stemfold.py) against its own resize-then-
conv1 and against the JAX package's fold, on the CPU.

Tolerances are the JAX package's own (tests/test_stemfold.py): in fp32 the
two border rows and columns within atol 2e-6 (the same linear operator,
only the band resize's contraction size differs) and everything within
atol 2e-5 / rtol 1e-5 (summation order); bf16 within 0.03 of the output's
scale. The pyramid at `EvalConfig()` (fold on) against the JAX default:
the same survivors, boxes within 1e-2 px, scores within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_evaluation import (EC, PROB, SCALES, TEMPLATES, TINY, assert_same_detections,
                                         detectors, images, shared_weights)
from tinyfaces_tpu import evaluation as jax_eval
from tinyfaces_tpu.config import DetectorConfig
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.ops import stemfold as jax_stemfold
from tinyfaces_tpu_torch.config import EvalConfig
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.ops import stemfold
from tinyfaces_tpu_torch.ops.resize import resize_batch, resize_weights
from tinyfaces_tpu_torch.utils.convert import from_jax

torch.set_num_threads(2)


def unfolded_stem(x: torch.Tensor, w7: torch.Tensor) -> torch.Tensor:
    """The pyramid's 2x level without the fold: the exact-2.0 resize of the
    whole canvas, then conv1 (7x7/2, pad 3)."""
    b, _, h, w = x.shape
    size = torch.tensor([[h, w]] * b)
    u = resize_batch(x, (2 * h, 2 * w), size, 2 * size)
    return F.conv2d(u, w7.to(x.dtype), stride=2, padding=3)


def _inputs(hw, o=16, seed=42, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, 3, *hw)).astype(np.float32)).to(dtype)
    w7 = torch.from_numpy((rng.standard_normal((o, 3, 7, 7)) * 0.1).astype(np.float32)).to(dtype)
    return x, w7


def test_phase_matrix_matches_the_ports_resize():
    """PHASE_G is the port's own exact-2x resize weights read off at an
    interior output row, and equals the JAX package's."""
    n = 16
    u = resize_weights(n, 2 * n, torch.tensor([2.0], dtype=torch.float64))[0].double().numpy()
    n0 = n // 2
    for k in range(7):
        row = u[2 * n0 + k - 3]
        np.testing.assert_allclose(row[n0 - 2:n0 + 3], stemfold.PHASE_G[k], atol=1e-12, rtol=0)
        assert row.sum() == pytest.approx(1.0, abs=1e-12)
    np.testing.assert_array_equal(stemfold.PHASE_G, jax_stemfold.PHASE_G)


def test_fold_kernel_equals_the_converted_jax_fold():
    """Folding (O, C, 7, 7) weights equals converting the JAX package's
    folded (5, 5, C, O) kernel of the same weights."""
    w7 = np.random.default_rng(0).standard_normal((7, 7, 3, 8)).astype(np.float32)
    want = np.asarray(jax_stemfold.fold_stem_kernel(jnp.asarray(w7))).transpose(3, 2, 0, 1)
    got = stemfold.fold_stem_kernel(torch.from_numpy(w7.transpose(3, 2, 0, 1).copy()))
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 3, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    # each tap's mass is kept: both columns of G sum to one per tap
    np.testing.assert_allclose(got.sum((2, 3)).numpy(), w7.sum((0, 1)).T, rtol=1e-5)


@pytest.mark.parametrize("hw", [(32, 32), (64, 96), (48, 160)])
def test_folded_equals_unfolded_fp32(hw):
    x, w7 = _inputs(hw)
    want = unfolded_stem(x, w7).numpy()
    got = stemfold.folded_stem_2x(x, w7).numpy()
    assert got.shape == want.shape == (2, 16, *hw)
    for sl in (np.s_[:, :, :2], np.s_[:, :, -2:], np.s_[..., :2], np.s_[..., -2:]):
        np.testing.assert_allclose(got[sl], want[sl], atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_folded_equals_unfolded_bf16():
    x, w7 = _inputs((32, 48), o=8, seed=7, dtype=torch.bfloat16)
    want = unfolded_stem(x, w7).float().numpy()
    got = stemfold.folded_stem_2x(x, w7)
    assert got.dtype == torch.bfloat16
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.03 * scale, rtol=0)


@pytest.mark.parametrize("hw", [(32, 48), (64, 64)])
def test_folded_matches_jax_on_converted_weights(hw):
    x, w7 = _inputs(hw, seed=3)
    want = np.asarray(jax_stemfold.folded_stem_2x(jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                                                  jnp.asarray(w7.permute(2, 3, 1, 0).numpy())))
    got = stemfold.folded_stem_2x(x, w7).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_stem_precomputed_entry_starts_at_bn1():
    params, stats = shared_weights(4)
    model = TinyFacesDetector(stage_sizes=TINY).eval()
    model.load_state_dict(from_jax(params, stats))
    x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (2, 64, 96, 3)).astype(np.float32))
    with torch.no_grad():
        stem = model.model.conv1(x.permute(0, 3, 1, 2))
        got = model(stem, stem_precomputed=True)
        want = model(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    apply = jax.jit(lambda v, s: JaxDetector(stage_sizes=TINY).apply(v, s, stem_precomputed=True))
    jwant = apply({"params": params, "batch_stats": stats}, jnp.asarray(stem.permute(0, 2, 3, 1).numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=2e-4, rtol=1e-4)


def _counted_fold(monkeypatch):
    from tinyfaces_tpu_torch import evaluation

    calls = []

    def fold(x, w7):
        calls.append(tuple(x.shape))
        return stemfold.folded_stem_2x(x, w7)

    monkeypatch.setattr(evaluation, "folded_stem_2x", fold)
    return calls


@pytest.mark.parametrize("seed", [1, 5])
def test_default_pyramid_folds_and_matches_jax_default(monkeypatch, seed):
    """EvalConfig() folds at the 2x level (once per batch) and matches the
    JAX default's fold; image 5 is ragged (95x117 inside a 128x128 canvas)."""
    params, stats = shared_weights()
    jd = jax_eval.PyramidDetector(JaxDetector(stage_sizes=TINY),
                                  {"params": params, "batch_stats": stats}, TEMPLATES,
                                  cfg=DetectorConfig(), ec=EC)
    assert jd.ec.fold_stem and EC.fold_stem and EvalConfig().fold_stem
    _, td = detectors(params, stats)
    img = images(seed)[2] if seed == 1 else np.random.default_rng(23).integers(
        0, 255, (95, 117, 3), dtype=np.uint8)
    calls = _counted_fold(monkeypatch)
    got = td.detect(img, prob_thresh=PROB, scales=SCALES)
    assert len(calls) == 1
    want = jd.detect(img, prob_thresh=PROB, scales=SCALES)
    assert want.shape[0] > 10
    assert_same_detections(got, want)


def test_fold_off_resizes(monkeypatch):
    """fold_stem=False never folds and resizes the 2x level as before; it
    matches the folded pyramid at the same tolerances."""
    params, stats = shared_weights()
    _, folded = detectors(params, stats)
    _, plain = detectors(params, stats, ec=EvalConfig(**{**EC.__dict__, "fold_stem": False}))
    calls = _counted_fold(monkeypatch)
    imgs = images(2)
    got = plain.detect_batch(imgs, prob_thresh=PROB, scales=SCALES)
    assert calls == []
    want = folded.detect_batch(imgs, prob_thresh=PROB, scales=SCALES)
    assert len(calls) == 1  # one canvas for the batch
    for g, w in zip(got, want):
        assert_same_detections(g, w)

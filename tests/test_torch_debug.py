"""The port's debug rendering (data/debug.py) against the JAX package's on
the CPU: heatmap_to_boxes gives the same boxes and scores (float32, equal
up to 1e-5 of a pixel: exp and the products round alike in NumPy on both
sides; the NMS survivors and their order equal), the rendered images are
pixel-equal, and GT heatmaps decode back to the GT box (the JAX package's
tests/test_integration.py check, on the port's build_targets).
"""

import numpy as np
import pytest
import torch
from PIL import Image

from tinyfaces_tpu.data import debug as jax_debug
from tinyfaces_tpu_torch.config import DetectorConfig
from tinyfaces_tpu_torch.data import debug, load_templates
from tinyfaces_tpu_torch.data.targets import build_targets

TEMPLATES = load_templates()
CFG = DetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=8)


def _maps(seed):
    rng = np.random.default_rng(seed)
    cls = rng.uniform(0, 1, (16, 16, 25)).astype(np.float32)
    reg = rng.normal(0, 0.3, (16, 16, 100)).astype(np.float32)
    return cls, reg


@pytest.mark.parametrize("prob,nms", [(0.99, 1.0), (0.97, 0.3), (0.9, 0.1), (1.5, 0.3)])
def test_heatmap_to_boxes_matches_jax(prob, nms):
    cls, reg = _maps(int(prob * 100))
    got = debug.heatmap_to_boxes(cls, reg, TEMPLATES, CFG, prob_thresh=prob, nms_thresh=nms)
    want = jax_debug.heatmap_to_boxes(cls, reg, TEMPLATES, CFG, prob_thresh=prob, nms_thresh=nms)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == np.asarray(w).shape
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
    if prob < 1:
        assert got[0].shape[0] > 0
    if nms < 1 and prob < 1:
        assert got[0].shape[0] < int((cls >= prob).sum())


def test_rendering_matches_jax(capsys):
    cls, reg = _maps(3)
    # boxes PIL can draw (x2 >= x1 after the decode's abs()): small
    # regressions, nothing on the first two rows and columns (row 0 centres
    # at -1 px)
    reg *= 0.05
    cls[:2] = cls[:, :2] = 0
    img = np.random.default_rng(1).integers(0, 255, (128, 128, 3), dtype=np.uint8)
    got = debug.visualize_heatmaps(Image.fromarray(img), cls, reg, TEMPLATES, CFG, 0.98, 0.3, show=False)
    want = jax_debug.visualize_heatmaps(Image.fromarray(img), cls, reg, TEMPLATES, CFG, 0.98, 0.3,
                                        show=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert not np.array_equal(np.asarray(got), img)
    x = np.random.default_rng(2).normal(0, 1, (128, 128, 3)).astype(np.float32)
    logits = np.random.default_rng(4).normal(0, 2, (16, 16, 25))
    logits[:2] = logits[:, :2] = -10
    out = np.concatenate([logits, reg], -1)
    np.testing.assert_array_equal(debug.denormalize_image(x), jax_debug.denormalize_image(x))
    got = debug.visualize_output(x, out, TEMPLATES, CFG, show=False)
    want = jax_debug.visualize_output(x, out, TEMPLATES, CFG, show=False)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert "Number of bboxes" in capsys.readouterr().out


def test_gt_heatmaps_decode_back_to_the_gt():
    gt = np.array([[40.0, 40.0, 90.0, 100.0]], np.float32)
    batch = {"image": torch.zeros((1, 128, 128, 3), dtype=torch.uint8),
             "gt_boxes": torch.from_numpy(np.tile(gt, (1, CFG.max_gt, 1))),
             "gt_valid": torch.from_numpy(np.arange(CFG.max_gt)[None] < 1),
             "paste_box": torch.tensor([[0.0, 0.0, 128.0, 128.0]]),
             "flip": torch.tensor([False])}
    _, cls, reg = build_targets(batch, torch.tensor(TEMPLATES, dtype=torch.float32),
                                torch.Generator().manual_seed(0), CFG)
    cls, reg = cls[0].numpy(), reg[0].numpy()
    boxes, scores = debug.heatmap_to_boxes(cls, reg, TEMPLATES, CFG, prob_thresh=1.0, nms_thresh=0.3)
    want = jax_debug.heatmap_to_boxes(cls, reg, TEMPLATES, CFG, prob_thresh=1.0, nms_thresh=0.3)
    np.testing.assert_allclose(boxes, np.asarray(want[0]), atol=1e-5, rtol=0)
    assert boxes.shape[0] >= 1 and (scores == 1).all()
    center_err = np.abs((boxes[:, :2] + boxes[:, 2:]) / 2 - np.array([65.0, 70.0])).min(axis=0)
    assert (center_err < 8).all()

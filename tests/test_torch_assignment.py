"""The port's GT assignment against the JAX package on the CPU.

Inputs come from numpy seeds; where the JAX side draws tie-break noise the
same draws are fed to the port. Tolerances: IoU values are computed with
the same float32 operations in the same order (1e-6 allows for a different
division routine); regression targets go through log(), 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyfaces_tpu.config import DetectorConfig
from tinyfaces_tpu.data.targets import build_targets as jax_build_targets
from tinyfaces_tpu.ops.assignment import assign_targets as jax_assign_targets
from tinyfaces_tpu.ops.assignment import compute_pad_mask as jax_compute_pad_mask
from tinyfaces_tpu.ops.dense_overlap import compute_dense_overlap as jax_dense_overlap
from tinyfaces_tpu.ops.pallas_assignment import (
    dense_assignment_reductions as jax_reductions,
)
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.data.targets import build_targets
from tinyfaces_tpu_torch.ops.assignment import compose_targets, compute_pad_mask
from tinyfaces_tpu_torch.ops.assignment_kernel import (
    assign_targets_fused,
    dense_assignment_reductions,
    dense_assignment_reductions_reference,
    drop_degenerate,
)
from tinyfaces_tpu_torch.ops.dense_overlap import compute_dense_overlap

torch.set_num_threads(2)

RF = dict(ofx=-1.0, ofy=-1.0, stx=8.0, sty=8.0)
THR = dict(pos_thresh=0.7, neg_thresh=0.3)
CFG = DetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=8)


def make_scene(seed, nt=6, g=8, n_valid=5, slots=None):
    """Same generator as tests/test_pallas_assignment.py::make_scene; with
    `slots` the n_valid boxes sit at those indices of the padded list and
    the slots between them hold zero-extent invalid boxes."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(8, 120, nt)
    h = rng.uniform(8, 120, nt)
    templates = np.stack([-w / 2, -h / 2, w / 2, h / 2, np.ones(nt)], axis=1).astype(np.float32)
    slots = list(range(n_valid)) if slots is None else list(slots)
    assert len(slots) == n_valid
    gt = np.zeros((g, 4), np.float32)
    for i in slots:
        x1, y1 = rng.uniform(0, 120, 2)
        gt[i] = [x1, y1, x1 + rng.uniform(10, 70), y1 + rng.uniform(10, 70)]
    valid = np.isin(np.arange(g), slots)
    return templates, gt, valid


# (seed, vsy, vsx, g, n_valid, slots): 20 rows is ragged against the
# Pallas 8-row blocks, 13 too; G=1; no valid GT; a valid mask with holes;
# a first valid GT past index 0.
SCENES = [(0, 20, 24, 8, 5, None), (1, 13, 24, 8, 5, None), (2, 20, 24, 1, 1, None),
          (3, 12, 12, 8, 0, None), (4, 20, 24, 12, 5, (0, 2, 3, 7, 10)), (5, 13, 24, 8, 3, (3, 4, 6))]


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_overlap_matches_jax(seed):
    templates, gt, valid = make_scene(seed)
    want = np.asarray(jax_dense_overlap(-1.0, -1.0, 8.0, 8.0, 24, 20, jnp.asarray(templates),
                                        jnp.asarray(gt), jnp.asarray(valid)))
    got = compute_dense_overlap(-1.0, -1.0, 8.0, 8.0, 24, 20, t(templates), t(gt)[None],
                                t(valid)[None])[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("scene", SCENES)
def test_reference_reductions_match_pallas_interpret(scene):
    """Noise off on both sides: the twin equals the Pallas kernel run in
    interpret mode (whose on-core PRNG is off there)."""
    seed, vsy, vsx, g, n_valid, slots = scene
    templates, gt, valid = make_scene(seed, g=g, n_valid=n_valid, slots=slots)
    want = jax_reductions(jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(templates),
                          jnp.int32(seed), vsx=vsx, vsy=vsy, interpret=True, **RF)
    got = dense_assignment_reductions(t(gt)[None], t(valid)[None], t(templates),
                                      torch.tensor([seed], dtype=torch.int32),
                                      vsx=vsx, vsy=vsy, noise=False, **RF)
    best_iou, best_gt, pgt_max, pgt_idx = (x[0].numpy() for x in got)
    np.testing.assert_allclose(best_iou, np.asarray(want[0]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(best_gt, np.asarray(want[1]))
    np.testing.assert_allclose(pgt_max, np.asarray(want[2]), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(pgt_idx, np.asarray(want[3]))


@pytest.mark.parametrize("flip", [False, True])
def test_pad_mask_matches_jax(flip):
    templates, _, _ = make_scene(5)
    box = np.array([10.0, 4.0, 150.0, 120.0], np.float32)
    want = np.asarray(jax_compute_pad_mask(jnp.asarray(box), jnp.asarray(templates), vsx=24,
                                           vsy=20, flip=flip, **RF))
    got = compute_pad_mask(t(box)[None], t(templates), vsx=24, vsy=20,
                           flip=torch.tensor([flip]), **RF)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scene", SCENES)
def test_composition_with_jax_noise_matches_assign_targets(scene):
    """The twin's reductions plus compose_targets, fed JAX's own tie-break
    draws, reproduce ops/assignment.assign_targets."""
    seed, vsy, vsx, g, n_valid, slots = scene
    templates, gt, valid = make_scene(seed, g=g, n_valid=n_valid, slots=slots)
    if n_valid >= 2:
        gt[1, 2] = gt[1, 0]  # a degenerate box: dropped before assignment
        gt[-1] = gt[0] + 0.5  # a near-twin of GT 0, likely sharing its best anchor
        valid[-1] = True
    box = np.array([0.0, 0.0, 170.0, 150.0], np.float32)
    key = jax.random.PRNGKey(seed)
    pad = jax_compute_pad_mask(jnp.asarray(box), jnp.asarray(templates), vsx=vsx, vsy=vsy, **RF)
    cls_w, reg_w, _ = jax_assign_targets(jnp.asarray(gt), jnp.asarray(valid), pad,
                                         jnp.asarray(templates), key, **RF, **THR)
    noise = np.asarray(1e-6 * jax.random.uniform(key, (vsy, vsx, len(templates), g)))

    gt_t, templates_t = t(gt)[None], t(templates)
    valid_t = drop_degenerate(gt_t, t(valid)[None])
    red = dense_assignment_reductions_reference(
        gt_t, valid_t, templates_t, torch.zeros(1, dtype=torch.int32), vsx=vsx, vsy=vsy,
        noise_tensor=t(noise)[None], **RF)
    cls, reg = compose_targets(*red, gt_t, valid_t, t(np.asarray(pad))[None], templates_t,
                               **RF, **THR)
    np.testing.assert_array_equal(cls[0].numpy(), np.asarray(cls_w))
    np.testing.assert_allclose(reg[0].numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)

    # The dispatching entry point takes the same draws on CPU tensors.
    cls2, reg2 = assign_targets_fused(gt_t, t(valid)[None], t(np.asarray(pad))[None],
                                      templates_t, None, noise_tensor=t(noise)[None],
                                      **RF, **THR)
    np.testing.assert_array_equal(cls2.numpy(), cls.numpy())
    np.testing.assert_array_equal(reg2.numpy(), reg.numpy())


def _toy_batch(b, cfg, seed):
    rng = np.random.default_rng(seed)
    gt = np.zeros((b, cfg.max_gt, 4), np.float32)
    valid = np.zeros((b, cfg.max_gt), bool)
    for i in range(b):
        n = rng.integers(0, cfg.max_gt + 1)
        xy = rng.uniform(0, 100, (n, 2))
        wh = rng.uniform(8, 60, (n, 2))
        gt[i, :n] = np.concatenate([xy, xy + wh], 1)
        valid[i, :n] = True
    x1, y1 = rng.uniform(0, 20, 2)
    return {
        "image": rng.integers(0, 255, (b, *cfg.input_size, 3), dtype=np.uint8),
        "gt_boxes": gt,
        "gt_valid": valid,
        "paste_box": np.tile(np.array([x1, y1, 120, 110], np.float32), (b, 1)),
        "flip": np.arange(b) % 2 == 1,
    }


def test_build_targets_matches_jax():
    templates = load_templates()
    batch = _toy_batch(3, CFG, seed=11)
    key = jax.random.PRNGKey(4)
    imgs_w, cls_w, reg_w = jax_build_targets({k: jnp.asarray(v) for k, v in batch.items()},
                                             jnp.asarray(templates, jnp.float32), key, CFG)
    vsy, vsx = CFG.heatmap_size
    shape = (vsy, vsx, CFG.num_templates, CFG.max_gt)
    noise = np.stack([np.asarray(1e-6 * jax.random.uniform(k, shape))
                      for k in jax.random.split(key, 3)])

    imgs, cls, reg = build_targets({k: t(v) for k, v in batch.items()},
                                   torch.tensor(templates), None, CFG, noise_tensor=t(noise))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(imgs_w), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(cls_w))
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    assert (cls.numpy() == 1).any() and (cls.numpy() == 0).any()


def test_cpu_dispatch_counts_no_launch():
    """CPU tensors take the twin: the kernel's launch counter stays put."""
    from tinyfaces_tpu_torch.utils import graphs

    before = graphs.launches("k1")
    templates, gt, valid = make_scene(0)
    dense_assignment_reductions(t(gt)[None], t(valid)[None], t(templates),
                                torch.zeros(1, dtype=torch.int32), vsx=8, vsy=8, **RF)
    assert graphs.launches("k1") == before

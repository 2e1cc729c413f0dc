"""N1's plain version (ops/nms_kernel.py) against the JAX NMS and the fixpoint.

`nms_bitmask_reference` runs N1's algorithm (valid extent, suppression
words, 64-row chunks) in plain PyTorch. Fed the port's ranking, its keep
mask must equal the JAX package's `ops.nms.nms` and the port's
`_fixpoint_keep` exactly, with no tolerance. N = 1200 and 4000 lie above
the JAX scheme's 2 x 512 switch, so its blocked loop runs. The scenes hold
clustered boxes on a 0.5 px grid, zero-area and duplicate boxes, and either
scores on a coarse grid or all equal (the stable ranking decides); the
valid counts include 0, 1 and the word edges 63, 64, 65.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyfaces_tpu.ops.nms import nms as jax_nms
from tinyfaces_tpu_torch.ops import boxes as port_boxes
from tinyfaces_tpu_torch.ops import nms, nms_kernel


def _scene(rng, n, n_valid=None, equal_scores=False):
    """(boxes (n, 4) f32, scores (n,) f32, valid (n,) bool): clusters of
    boxes, one in 16 of zero width or height, one in 32 a copy of its
    neighbour; `n_valid` valid rows at random places (else ~85%)."""
    k = max(2, n // 60)
    centres = rng.uniform(50, 950, (k, 2))
    c = centres[rng.integers(0, k, n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    zero = rng.uniform(size=n) < 1 / 16
    wh[zero, rng.integers(0, 2, int(zero.sum()))] = 0.0
    b = np.concatenate([c - wh / 2, c + wh / 2], 1)
    b = (np.round(b * 2) / 2).astype(np.float32)
    dup = np.nonzero(rng.uniform(size=n - 1) < 1 / 32)[0]
    b[dup + 1] = b[dup]
    if equal_scores:
        s = np.full(n, 0.5, np.float32)
    else:
        s = (rng.integers(0, 40, n) / 8.0 - 2.0).astype(np.float32)
    if n_valid is None:
        v = rng.uniform(size=n) > 0.15
    else:
        v = np.zeros(n, bool)
        v[rng.permutation(n)[:n_valid]] = True
    return b, s, v


def _ranked(b, s, v):
    """The port's ranking (nms.nms's order) of a batch of scenes, as torch."""
    bt, st, vt = (torch.from_numpy(np.stack(x)) for x in (b, s, v))
    order, _ = nms.nms(bt, st, 0.5, vt)
    n = order.shape[1]
    return bt.gather(1, order[..., None].expand(-1, n, 4)), vt.gather(1, order), order


@pytest.mark.parametrize("n,n_valid,thresh,equal", [
    (1200, None, 0.3, False), (1200, None, 0.5, True),
    (4000, None, 0.3, False), (4000, None, 0.5, True),
    (300, 0, 0.3, False), (300, 1, 0.5, False), (300, 63, 0.3, True),
    (300, 64, 0.5, False), (300, 65, 0.3, False), (4000, 65, 0.5, False),
])
def test_bitmask_reference_matches_jax_and_fixpoint(n, n_valid, thresh, equal):
    rng = np.random.default_rng(n + (n_valid or 0) + int(10 * thresh))
    b, s, v = _scene(rng, n, n_valid, equal)
    boxes_sorted, valid_sorted, order = _ranked([b], [s], [v])
    got = nms_kernel.nms_bitmask_reference(boxes_sorted, valid_sorted, thresh)[0].numpy()

    j_order, j_keep = jax_nms(jnp.asarray(b), jnp.asarray(s), thresh, jnp.asarray(v))
    np.testing.assert_array_equal(order[0].numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(got, np.asarray(j_keep))
    fix = nms._fixpoint_keep(boxes_sorted, valid_sorted, thresh)[0].numpy()
    np.testing.assert_array_equal(got, fix)
    assert not got[~valid_sorted[0].numpy()].any()
    if n_valid != 0:
        assert 0 < got.sum() <= v.sum()


def test_bitmask_reference_batch_equals_single_images():
    """Images of extents 0, 1, 64, 65 and ~1000 in one (5, 1200) batch, each
    equal to its own run and to the fixpoint of the batch."""
    rng = np.random.default_rng(11)
    scenes = [_scene(rng, 1200, k) for k in (0, 1, 64, 65, None)]
    boxes_sorted, valid_sorted, _ = _ranked(*zip(*scenes))
    got = nms_kernel.nms_bitmask_reference(boxes_sorted, valid_sorted, 0.3)
    for i in range(len(scenes)):
        one = nms_kernel.nms_bitmask_reference(boxes_sorted[i:i + 1], valid_sorted[i:i + 1], 0.3)
        np.testing.assert_array_equal(got[i].numpy(), one[0].numpy())
    np.testing.assert_array_equal(got.numpy(), nms._fixpoint_keep(boxes_sorted, valid_sorted, 0.3).numpy())
    assert nms_kernel.valid_extent(valid_sorted).tolist() == [0, 1, 64, 65, int(scenes[4][2].sum())]


def test_suppression_words_layout():
    """Bit j of word w of row i is IoU(i, 64 w + j) > thr for a column
    ranked below i inside the extent; bit 63 included."""
    rng = np.random.default_rng(3)
    n = 150
    b, s, v = _scene(rng, n, 140)
    boxes_sorted, valid_sorted, _ = _ranked([b], [s], [v])
    words, extent = nms_kernel.suppression_words(boxes_sorted, valid_sorted, 0.3)
    assert words.shape == (1, n, 3) and words.dtype == torch.int64 and extent.tolist() == [140]
    bits = ((words[..., None] >> torch.arange(64)) & 1).reshape(1, n, 192)[:, :, :n].bool()
    iou = port_boxes.pairwise_iou(boxes_sorted, boxes_sorted)
    idx = torch.arange(n)
    want = (iou > 0.3) & (idx[:, None] < idx[None, :]) & (idx[None, :, None] < 140) & (idx[None, None, :] < 140)
    np.testing.assert_array_equal(bits.numpy(), want.numpy())
    assert bits[0, :, 63].any() and (words[0, :, 0] < 0).any()  # bit 63 is the sign bit


def test_nms_bound_hand_count():
    """Extents (3, 0, 65) among 70 rows: 3 + 0 + 2080 valid pairs at 14 fp32
    operations each, one issue slot apiece (67 TFLOP/s counts an FMA as
    two); 70 rows of 16 + 1 + 1 bytes per image against 3.35 TB/s, which
    binds; 3 + 128 + 1 mask words. With a keep mask only the pairs under a
    kept row count: rows 0 and 2 of the first image (2 + 0), rows 0 and 64
    of the last (64 + 0), and nothing past an extent."""
    r = nms_kernel.nms_bound([3, 0, 65], 70)
    assert r["valid_pairs"] == r["needed_pairs"] == 2083
    assert r["operations_ms"] == pytest.approx(14 * 2083 / 33.5e12 * 1e3)
    assert r["bytes_ms"] == pytest.approx(3 * 70 * 18 / 3.35e12 * 1e3)
    assert r["bound_by"] == "bytes" and r["bound_ms"] == r["bytes_ms"]
    assert r["mask_bytes_ms"] == pytest.approx(2 * 8 * 132 / 3.35e12 * 1e3)
    assert r["serial_chain_ms"] == pytest.approx(65 * 8 / 1.98e9 * 1e3)
    keep = torch.zeros(3, 70, dtype=torch.bool)
    keep[0, [0, 2]] = True
    keep[1, 5] = True  # past the extent 0
    keep[2, [0, 64, 66]] = True  # 66: past the extent 65
    k = nms_kernel.nms_bound(torch.tensor([3, 0, 65]), 70, keep)
    assert k["valid_pairs"] == 2083 and k["needed_pairs"] == 66
    assert k["operations_ms"] == pytest.approx(14 * 66 / 33.5e12 * 1e3)
    full = nms_kernel.nms_bound(torch.tensor([4000] * 32), 4000)
    assert full["bound_by"] == "operations"
    assert full["bound_ms"] == pytest.approx(14 * 32 * 4000 * 3999 / 2 / 33.5e12 * 1e3)
    assert nms_kernel.workspace(32, 4000, torch.device("meta"))[0].numel() * 8 == 32 * 4000 * math.ceil(4000 / 64) * 8


def test_keep_dispatch_by_device():
    """nms() is the one dispatch point: CPU tensors take the plain fixpoint;
    tensors on any other device go to N1's wrapper, which takes CUDA
    tensors only."""
    rng = np.random.default_rng(5)
    b, s, v = _scene(rng, 100)
    boxes_sorted, valid_sorted, _ = _ranked([b], [s], [v])
    order, keep = nms.nms(torch.from_numpy(b)[None], torch.from_numpy(s)[None], 0.3,
                          torch.from_numpy(v)[None])
    np.testing.assert_array_equal(keep.numpy(), nms._fixpoint_keep(boxes_sorted, valid_sorted, 0.3).numpy())
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel._launch(boxes_sorted.to("meta"), valid_sorted.to("meta"), 0.3)
    with pytest.raises(ValueError, match="CUDA"):
        nms.nms(torch.from_numpy(b)[None].to("meta"), torch.from_numpy(s)[None].to("meta"), 0.3,
                torch.from_numpy(v)[None].to("meta"))

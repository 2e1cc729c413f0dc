"""N1's plain version (ops/nms_kernel.py) against the JAX NMS and the fixpoint.

`nms_blocked_reference` runs N1's algorithm (64-row chunks in rank order,
each resolved against its diagonal tile, then its kept rows' forward
suppression) in plain PyTorch. Fed the port's ranking, its keep mask must
equal the JAX package's `ops.nms.nms` and the port's `_fixpoint_keep`
exactly, with no tolerance. N = 1200 and 4000 lie above the JAX scheme's
2 x 512 switch, so its blocked loop runs. The scenes hold clustered boxes
on a 0.5 px grid, zero-area and duplicate boxes, and either scores on a
coarse grid or all equal (the stable ranking decides); the valid counts
include 0, 1, N and the chunk edges 63, 64, 65. Invalid rows interleaved
below valid ones and NaN coordinates go to the keep step directly, as the
kernel may receive them.
"""

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
    (4000, 4000, 0.3, False), (1, 1, 0.5, False),
])
def test_bitmask_reference_matches_jax_and_fixpoint(n, n_valid, thresh, equal):
    rng = np.random.default_rng(n + (n_valid or 0) + int(10 * thresh))
    b, s, v = _scene(rng, n, n_valid, equal)
    boxes_sorted, valid_sorted, order = _ranked([b], [s], [v])
    got = nms_kernel.nms_blocked_reference(boxes_sorted, valid_sorted, thresh)[0].numpy()

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
    got = nms_kernel.nms_blocked_reference(boxes_sorted, valid_sorted, 0.3)
    for i in range(len(scenes)):
        one = nms_kernel.nms_blocked_reference(boxes_sorted[i:i + 1], valid_sorted[i:i + 1], 0.3)
        np.testing.assert_array_equal(got[i].numpy(), one[0].numpy())
    np.testing.assert_array_equal(got.numpy(), nms._fixpoint_keep(boxes_sorted, valid_sorted, 0.3).numpy())
    assert nms_kernel.valid_extent(valid_sorted).tolist() == [0, 1, 64, 65, int(scenes[4][2].sum())]


def test_blocked_reference_direct_inputs():
    """The keep step fed directly, as the kernel may be: invalid rows
    interleaved below valid ones (the extent past the valid count) and valid
    boxes with a NaN coordinate (their IoU is NaN, never > threshold, as in
    pairwise_iou). The blocked reference equals the fixpoint, the plain
    keep step (which runs the fixpoint up to the largest valid extent) and,
    on the interleaved rows, the JAX NMS over the valid rows alone."""
    rng = np.random.default_rng(17)
    b, s, v = _scene(rng, 1500, 1500)
    boxes_sorted, _, _ = _ranked([b], [s], [v])
    holes = torch.from_numpy(rng.uniform(size=(1, 1500)) < 0.3)
    holes[0, -1] = False
    valid = ~holes
    assert int(nms_kernel.valid_extent(valid)) == 1500 > int(valid.sum())
    got = nms_kernel.nms_blocked_reference(boxes_sorted, valid, 0.3)
    np.testing.assert_array_equal(got.numpy(), nms._fixpoint_keep(boxes_sorted, valid, 0.3).numpy())
    np.testing.assert_array_equal(got.numpy(), nms._plain_keep(boxes_sorted, valid, 0.3).numpy())
    idx = np.nonzero(valid[0].numpy())[0]
    sub = boxes_sorted[0].numpy()[idx]
    scores = -np.arange(len(idx), dtype=np.float32)  # keeps the rank order
    j_order, j_keep = jax_nms(jnp.asarray(sub), jnp.asarray(scores), 0.3)
    np.testing.assert_array_equal(np.asarray(j_order), np.arange(len(idx)))
    np.testing.assert_array_equal(got[0].numpy()[idx], np.asarray(j_keep))
    assert not got[0][holes[0]].any()

    nan_boxes = boxes_sorted.clone()
    hit = torch.from_numpy(rng.uniform(size=(1, 1500)) < 0.05)
    coord = torch.from_numpy(rng.integers(0, 4, (1, 1500)))
    nan_boxes[hit, coord[hit]] = float("nan")
    all_valid = torch.ones(1, 1500, dtype=torch.bool)
    got = nms_kernel.nms_blocked_reference(nan_boxes, all_valid, 0.5)
    np.testing.assert_array_equal(got.numpy(), nms._fixpoint_keep(nan_boxes, all_valid, 0.5).numpy())
    np.testing.assert_array_equal(got.numpy(), nms._plain_keep(nan_boxes, all_valid, 0.5).numpy())
    assert got[hit].all()  # a NaN box overlaps nothing: nothing suppresses it


def test_chunk_step_against_pairwise_iou():
    """One chunk of the blocked loop on a hand-built scene of 150 rows: the
    diagonal tile is pairwise_iou > thr between live rows r < j of the
    chunk; the kept rows are the greedy ones of the chunk; the forward
    suppression marks exactly the later rows that a kept row overlaps (or
    that were dead), and the chunk's own rows are dead unless kept."""
    n, thr = 150, 0.3
    x = 4.0 * np.arange(n, dtype=np.float32) % 400  # rows 100 apart coincide
    boxes = torch.from_numpy(np.stack([x, np.zeros_like(x), x + 10, np.full_like(x, 10)], 1))[None]
    boxes = torch.nn.functional.pad(boxes, (0, 0, 0, 192 - n))
    dead = torch.zeros(1, 192, dtype=torch.bool)
    dead[0, n:] = True  # padding
    dead[0, [5, 70, 101]] = True  # invalid or already suppressed
    iou = port_boxes.pairwise_iou(boxes, boxes)[0]
    for c in (0, 1, 2):
        live = ~dead[0, 64 * c:64 * (c + 1)]
        diag, kept, after = nms_kernel.chunk_step(boxes, dead, c, thr)
        tile = iou[64 * c:64 * (c + 1), 64 * c:64 * (c + 1)] > thr
        want = tile & torch.ones(64, 64, dtype=torch.bool).triu(1) & live[:, None] & live[None, :]
        np.testing.assert_array_equal(diag[0].numpy(), want.numpy())
        greedy = torch.zeros(64, dtype=torch.bool)
        for j in range(64):
            greedy[j] = live[j] and not (greedy[:j] & want[:j, j]).any()
        np.testing.assert_array_equal(kept[0].numpy(), greedy.numpy())
        later = (iou[64 * c:64 * (c + 1), 64 * (c + 1):] > thr)[greedy].any(0)
        np.testing.assert_array_equal(after[0, 64 * (c + 1):].numpy(),
                                      (dead[0, 64 * (c + 1):] | later).numpy())
        np.testing.assert_array_equal(after[0, 64 * c:64 * (c + 1)].numpy(), (~greedy).numpy())
        np.testing.assert_array_equal(after[0, :64 * c].numpy(), dead[0, :64 * c].numpy())
        if c == 0:
            assert kept[0].sum() > 1 and (~kept[0] & live).any() and later.any()
        dead = after


def test_nms_bound_hand_count():
    """Three images of 70 rows: rows 0-2 valid, none valid, rows 0-64 valid
    but row 10 (extents 3, 0, 65). Kept: rows 0 and 2 of the first (K 2 of
    3 valid), row 5 of the second and rows 0, 64 and 66 of the third, where
    only the valid ones count (K 0 of 0 and 2 of 64). The tests any exact
    algorithm needs: the kept pairs, K (K - 1) / 2, plus one a valid row not
    kept: (1 + 1) + 0 + (1 + 62) = 65, at 14 fp32 operations each, one issue
    slot apiece (67 TFLOP/s counts an FMA as two); 70 rows of 16 + 1 + 1
    bytes an image against 3.35 TB/s, which binds. The design's chain is
    the longest extent's 2 chunks, each two resolve rounds of 30 cycles and
    two barriers of 20: 200 cycles at 1.98 GHz. All 4000 rows of 32 images
    valid and kept: every pair is needed and the operations bind; one kept
    of 4000: one test a row."""
    valid = torch.zeros(3, 70, dtype=torch.bool)
    valid[0, :3] = True
    valid[2, :65] = True
    valid[2, 10] = False
    keep = torch.zeros(3, 70, dtype=torch.bool)
    keep[0, [0, 2]] = True
    keep[1, 5] = True
    keep[2, [0, 64, 66]] = True
    r = nms_kernel.nms_bound(valid, keep)
    assert r["kept"] == 4 and r["needed_pairs"] == 65
    assert r["valid_pairs"] == 3 + 0 + 64 * 63 // 2
    assert r["operations_ms"] == pytest.approx(14 * 65 / 33.5e12 * 1e3)
    assert r["bytes_ms"] == pytest.approx(3 * 70 * 18 / 3.35e12 * 1e3)
    assert r["bound_by"] == "bytes" and r["bound_ms"] == r["bytes_ms"]
    assert r["serial_chain_ms"] == pytest.approx(200 / 1.98e9 * 1e3)
    assert "mask_bytes_ms" not in r
    full = torch.ones(32, 4000, dtype=torch.bool)
    f = nms_kernel.nms_bound(full, full)
    assert f["bound_by"] == "operations" and f["needed_pairs"] == f["valid_pairs"] == 32 * 4000 * 3999 // 2
    assert f["bound_ms"] == pytest.approx(14 * 32 * 4000 * 3999 / 2 / 33.5e12 * 1e3)
    assert f["serial_chain_ms"] == pytest.approx(63 * 100 / 1.98e9 * 1e3)
    one = torch.zeros(1, 4000, dtype=torch.bool)
    one[0, 0] = True
    assert nms_kernel.nms_bound(full[:1], one)["needed_pairs"] == 3999


def test_smem_rows_hand_count():
    """The rows N1 stages in shared memory on an H100 (232,448 bytes a
    block), beside two buffers of kept boxes and areas (2560 B), the
    diagonal (512 B), four ints, the dead bitset (8 B a chunk) and 32
    warps' lists (2 B a row, room for 32 ceil(2 C / 31) rows each): at N =
    4000 every row fits; at N = 16,000 (250 chunks) (232448 - 2560 - 512 -
    16 - 2000 - 2 * 32 * 544) // 16 = 12,034; at the largest N, 65,536
    (1024 chunks), 5,247; with 16 warps a block at N = 16,000 the lists take
    as much (16 x 1088 rows)."""
    assert nms_kernel.smem_rows(4000) == 4000
    assert nms_kernel.smem_rows(16000) == (232448 - 2560 - 512 - 16 - 2000 - 2 * 32 * 544) // 16 == 12034
    assert nms_kernel.smem_rows(nms_kernel.MAX_N) == (232448 - 3088 - 8192 - 2 * 32 * 2144) // 16 == 5247
    assert nms_kernel.smem_rows(16000, threads=512) == (232448 - 3088 - 2000 - 2 * 16 * 1088) // 16 == 12034
    assert nms_kernel.smem_rows(100, optin=1000) == 0


def test_launch_shape_hand_count():
    """Blocks a cluster and threads a block N1 takes for B images: the first
    of 8 x 1024, 4 x 1024, 4 x 512, 2 x 512 with B x blocks x threads <=
    65,536, else 1 x 1024."""
    assert [nms_kernel.launch_shape(b) for b in (1, 8, 9, 16, 17, 32, 33, 64, 65, 400)] == [
        (8, 1024), (8, 1024), (4, 1024), (4, 1024), (4, 512), (4, 512), (2, 512), (2, 512),
        (1, 1024), (1, 1024)]


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


def _kernel_decision(inter, uni, thr):
    """csrc/nms.cu's IoU decision (Threshold, overlaps) for inter, uni > 0
    (float32 arrays) and a float32 threshold, in NumPy: inter > mid * uni,
    or == where the tie rounds up, in fp64."""
    inter, uni, thr = np.float32(inter), np.float32(uni), np.float32(thr)
    with np.errstate(over="ignore"):
        up = np.nextafter(thr, np.float32(np.inf))
    top = np.isinf(up) and not np.isinf(thr)
    mid = np.float64(thr) + 2.0 ** 103 if top else 0.5 * (np.float64(thr) + np.float64(up))
    tie_up = top or (int(up.view(np.uint32)) & 1) == 0
    p, q = mid * uni.astype(np.float64), inter.astype(np.float64)
    return (q > p) | (tie_up & (q == p))


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7, 0.0, -0.0, 1e-40, -0.25, 3.4028235e38, np.inf, np.nan])
def test_midpoint_decision_equals_fp32_division(thr):
    """The kernel decides IoU > thr without dividing: RN(inter / uni) > thr
    exactly when inter > mid * uni (or == and the tie rounds up), mid the
    midpoint between thr and the next float, the product exact in fp64.
    Against float32 division on random pairs and on pairs within a few ulps
    of the rounding boundary."""
    rng = np.random.default_rng(7)
    thr = np.float32(thr)
    uni = np.concatenate([rng.uniform(1, 1e6, 20000), 2.0 ** rng.uniform(-60, 60, 20000)]).astype(np.float32)
    inter = (uni * rng.uniform(0, 1.2, uni.size)).astype(np.float32)
    if np.isfinite(thr):
        with np.errstate(over="ignore"):
            up = np.float64(np.nextafter(thr, np.float32(np.inf)))
        near = uni.astype(np.float64) * (0.5 * (np.float64(thr) + up))
        near = near.astype(np.float32)
        steps = rng.integers(-3, 4, uni.size).astype(np.int32)
        bits = near.view(np.int32) + np.where(near >= 0, steps, -steps)
        inter = np.concatenate([inter, bits.view(np.float32)])
        uni = np.concatenate([uni, uni])
    keep = (inter >= 0) & np.isfinite(inter) & (uni > 0)
    inter, uni = inter[keep], uni[keep]
    want = (torch.from_numpy(inter) / torch.from_numpy(uni)) > float(thr)
    np.testing.assert_array_equal(_kernel_decision(inter, uni, thr), want.numpy())

"""The port's NMS against the JAX package and the float64 greedy oracle.

Boxes come in overlapping clusters with coordinates on a 0.5 px grid and
scores on a coarse grid, so equal scores are common and the stable ranking
decides; some rows are invalid. N is below and above the JAX scheme's
2*block = 1024 switch to its blocked form. Keep sets must be identical and
the packed outputs equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.oracle import greedy_nms_oracle
from tinyfaces_tpu.ops import boxes as jax_boxes
from tinyfaces_tpu.ops.nms import batched_nms_padded as jax_batched_nms_padded
from tinyfaces_tpu.ops.nms import nms as jax_nms
from tinyfaces_tpu_torch.ops import boxes, nms


def _clustered(rng, n, n_clusters):
    centres = rng.uniform(50, 950, (n_clusters, 2))
    c = centres[rng.integers(0, n_clusters, n)] + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], 1)
    b = (np.round(b * 2) / 2).astype(np.float32)
    scores = (rng.integers(0, 40, n) / 8.0 - 2.0).astype(np.float32)
    valid = rng.uniform(size=n) > 0.15
    return b, scores, valid


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, _, _ = _clustered(rng, 64, 4)
    a[3] = a[2]  # identical pair
    a[5, 2:] = a[5, :2]  # zero-area box
    got = boxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    want = np.asarray(jax_boxes.pairwise_iou(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(boxes.box_area(torch.from_numpy(a)).numpy(),
                                  np.asarray(jax_boxes.box_area(jnp.asarray(a))))


@pytest.mark.parametrize("n,n_clusters,thresh", [
    (300, 6, 0.3), (300, 6, 0.5), (1200, 20, 0.3), (1200, 20, 0.5),
])
def test_nms_matches_jax_and_oracle(n, n_clusters, thresh):
    rng = np.random.default_rng(n + int(10 * thresh))
    b, s, v = _clustered(rng, n, n_clusters)
    order, keep = nms.nms(torch.from_numpy(b)[None], torch.from_numpy(s)[None], thresh,
                          torch.from_numpy(v)[None])
    kept = np.sort(order[0][keep[0]].numpy())

    j_order, j_keep = jax_nms(jnp.asarray(b), jnp.asarray(s), thresh, jnp.asarray(v))
    np.testing.assert_array_equal(order[0].numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(kept, np.sort(np.asarray(j_order)[np.asarray(j_keep)]))

    idx = np.nonzero(v)[0]
    oracle = np.sort(idx[greedy_nms_oracle(b[idx].astype(np.float64), s[idx].astype(np.float64),
                                           thresh)])
    np.testing.assert_array_equal(kept, oracle)
    assert 0 < len(kept) < v.sum()


@pytest.mark.parametrize("max_out", [40, 5000])
def test_batched_nms_padded_matches_jax(max_out):
    rng = np.random.default_rng(7)
    imgs = [_clustered(rng, 400, 8) for _ in range(3)]
    imgs[2][2][:] = False  # an image without candidates
    b, s, v = (torch.from_numpy(np.stack(x)) for x in zip(*imgs))
    got = nms.batched_nms_padded(b, s, 0.3, v, max_out)
    for i in range(3):
        want = jax_batched_nms_padded(jnp.asarray(imgs[i][0]), jnp.asarray(imgs[i][1]), 0.3,
                                      jnp.asarray(imgs[i][2]), max_out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert not got[2][2].any()

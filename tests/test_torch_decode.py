"""The port's template pruning and top-K decode against the JAX package.

Score maps are random with quantised logits, so many cells tie: the tie
order of `lax.top_k` (lowest flat index first) must be reproduced. The
valid mask, template ids and positions must be equal, scores exact (they
are gathered logits), boxes within atol 1e-4 (fp32 arithmetic in another
order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyfaces_tpu.ops import decode as jax_decode
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.ops import decode

TEMPLATES = load_templates()
SCALES = [2.0**s for s in (-2, -1, -0.5, 0, 0.5, 1)]


@pytest.mark.parametrize("pruning", ["reference", "natural"])
def test_valid_template_mask_matches_jax(pruning):
    for s in SCALES:
        np.testing.assert_array_equal(
            decode.valid_template_mask(TEMPLATES, s, pruning),
            jax_decode.valid_template_mask(TEMPLATES, s, pruning))


def test_top_k_lowest_index_breaks_ties_like_lax():
    x = torch.tensor([[0.5, 0.7, 0.5, 0.7, 0.0, 0.5]])
    vals, idx = decode.top_k_lowest_index(x, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert vals.tolist() == [[pytest.approx(0.7), pytest.approx(0.7), 0.5, 0.5]]


def _score_map(rng, h, w):
    # logits on a 0.5 grid in [-3, 3]: many exact ties, no sigmoid saturation
    out = rng.normal(0, 0.25, (h, w, 125)).astype(np.float32)  # small regressions
    out[..., :25] = np.round(rng.uniform(-3, 3, (h, w, 25)) * 2) / 2
    return out


@pytest.mark.parametrize("case", [
    dict(h=12, w=17, k=60, ids=True, hw=(9, 13), scale=0.5),
    dict(h=12, w=17, k=60, ids=False, hw=None, scale=2.0),
    dict(h=7, w=9, k=40, ids=True, hw=None, scale=1.0),
    dict(h=3, w=4, k=200, ids=True, hw=(2, 3), scale=0.25),  # K larger than the map
    dict(h=3, w=4, k=400, ids=False, hw=(3, 2), scale=2.0**0.5),
])
def test_decode_scores_matches_jax(case):
    rng = np.random.default_rng(case["h"] * 100 + case["k"])
    out = _score_map(rng, case["h"], case["w"])
    mask = jax_decode.valid_template_mask(TEMPLATES, case["scale"])
    ids = tuple(int(i) for i in np.nonzero(mask)[0]) if case["ids"] else None
    kw = dict(prob_thresh=0.3, stride=8.0, offset=-1.0, scale=case["scale"], k=case["k"])

    want = jax_decode.decode_scores(
        jnp.asarray(out), jnp.asarray(TEMPLATES, jnp.float32), jnp.asarray(mask), **kw,
        valid_hw=None if case["hw"] is None else (jnp.int32(case["hw"][0]), jnp.int32(case["hw"][1])),
        valid_ids=ids)
    hw = None if case["hw"] is None else (torch.tensor([case["hw"][0]]), torch.tensor([case["hw"][1]]))
    got = decode.decode_scores(torch.from_numpy(out)[None], torch.tensor(TEMPLATES, dtype=torch.float32),
                               torch.from_numpy(mask), **kw, valid_hw=hw, valid_ids=ids)

    valid = np.asarray(want.valid)
    assert got.valid[0].numpy().tolist() == valid.tolist()
    assert valid.sum() > 5
    scores = np.asarray(want.scores)
    assert len(np.unique(scores[valid])) < valid.sum()  # ties among the kept cells
    np.testing.assert_array_equal(got.scores[0].numpy(), scores)
    # Each (position, template) gives its own box, so equal boxes in equal
    # order pin the winning cells and their tie order.
    np.testing.assert_allclose(got.boxes[0].numpy(), np.asarray(want.boxes), atol=1e-4, rtol=0)

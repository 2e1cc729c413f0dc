"""The kernel's tie-break noise mirror (`kernel_noise`) and the bound helper.

The CUDA kernel draws its noise from a counter hash; `kernel_noise` is its
plain PyTorch mirror, so the twin fed those draws agrees with the kernel at
the value level. Here, on the CPU: the mirror against a scalar Python
version of the hash, what the draws depend on, their distribution (a
chi-square over 64 bins of 10^6 draws at p > 1e-3, neighbour correlations
|r| < 0.01), the twin's own default draws (torch.rand per image seed),
and the twin fed the mirror's draws against the exact IoU (per-anchor
values within the noise's range of 1e-6, argmaxes moved only where the
exact top-2 gap is below it; both plus float32 rounding of the sum, at most
half an ulp of an IoU <= 1 for the value, one ulp for the gap).
"""

import numpy as np
import pytest
import torch
from scipy import stats

from tinyfaces_tpu_torch.ops.assignment_kernel import (
    dense_assignment_reductions_reference,
    k1_bound,
    kernel_noise,
    kernel_noise_bits,
    perturbed_iou,
    valid_pairs,
)

RF = dict(ofx=-1.0, ofy=-1.0, stx=8.0, sty=8.0)
M32 = 0xFFFFFFFF
VALUE_TOL = 1e-6 + 2.0**-25  # noise < 1e-6, iou + noise rounded to float32
GAP_TOL = 1e-6 + 2.0**-24


def fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def scalar_bits(seed: int, a: int, g: int) -> int:
    """The kernel's draw for (image seed, flat anchor index, original g),
    in Python integers."""
    akey = fmix32(fmix32((seed & M32) ^ 0x7F4A7C15) ^ a)
    return fmix32((akey + g * 0x9E3779B9) & M32) >> 8


def seeds(*s):
    return torch.tensor(s, dtype=torch.int32)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 2, -5])
def test_mirror_matches_scalar_hash(seed):
    vsy, vsx, t, g = 3, 4, 5, 6
    bits = kernel_noise_bits(seeds(seed), vsy, vsx, t, g)[0].reshape(-1, g)
    rng = np.random.default_rng(abs(seed))
    for a, gi in zip(rng.integers(0, vsy * vsx * t, 20), rng.integers(0, g, 20)):
        assert int(bits[a, gi]) == scalar_bits(seed, int(a), int(gi))
    assert int(bits.min()) >= 0 and int(bits.max()) < 2**24


def test_noise_depends_on_seed_anchor_and_g_only():
    a = kernel_noise(seeds(7, 11), 4, 6, 5, 9)
    assert torch.equal(a, kernel_noise(seeds(7, 11), 4, 6, 5, 9))  # deterministic
    # not on the batch it sits in, nor on the number of padded GT slots
    assert torch.equal(a[1], kernel_noise(seeds(11), 4, 6, 5, 9)[0])
    assert torch.equal(a[..., :4], kernel_noise(seeds(7, 11), 4, 6, 5, 4))
    # on the flat anchor index only, not on how the grid is cut
    assert torch.equal(a[0].reshape(-1, 9), kernel_noise(seeds(7), 6, 4, 5, 9)[0].reshape(-1, 9))
    # and on the seed
    assert (a[0] != a[1]).float().mean() > 0.99
    assert float(a.min()) >= 0.0 and float(a.max()) < 1e-6


def test_draws_are_uniform():
    bits = kernel_noise_bits(seeds(3), 20, 20, 25, 100).reshape(-1).numpy()  # 10^6 draws
    assert bits.size == 10**6
    counts = np.bincount(bits >> 18, minlength=64)  # the top 6 of 24 bits
    assert stats.chisquare(counts).pvalue > 1e-3
    low = np.bincount(bits & 63, minlength=64)  # and the lowest 6
    assert stats.chisquare(low).pvalue > 1e-3


def test_neighbouring_draws_are_uncorrelated():
    u = kernel_noise_bits(seeds(5), 20, 20, 25, 100)[0].reshape(-1, 100).numpy() / 2.0**24
    r_g = np.corrcoef(u[:, :-1].ravel(), u[:, 1:].ravel())[0, 1]  # g and g + 1
    r_a = np.corrcoef(u[:-1].ravel(), u[1:].ravel())[0, 1]  # anchor a and a + 1
    assert abs(r_g) < 0.01 and abs(r_a) < 0.01


def small_scene(seed, g=10, slots=(1, 2, 5, 8)):
    """Boxes of 10-70 px in a 170x150 canvas at `slots`, zero-extent
    invalid boxes between them; templates of 8-120 px."""
    rng = np.random.default_rng(seed)
    w, h = rng.uniform(8, 120, 6), rng.uniform(8, 120, 6)
    templates = np.stack([-w / 2, -h / 2, w / 2, h / 2], 1).astype(np.float32)
    gt = np.zeros((2, g, 4), np.float32)
    valid = np.zeros((2, g), bool)
    for b in range(2):
        for i in slots:
            x1, y1 = rng.uniform(0, 120, 2)
            gt[b, i] = [x1, y1, x1 + rng.uniform(10, 70), y1 + rng.uniform(10, 70)]
        valid[b, list(slots)] = True
    gt[1, slots[0]] = gt[1, slots[1]] + 0.25  # a near-twin: ties within the noise
    return torch.from_numpy(templates), torch.from_numpy(gt), torch.from_numpy(valid)


def top2_gap(x: torch.Tensor, dim: int) -> torch.Tensor:
    v = x.topk(2, dim=dim).values
    return v.select(dim, 0) - v.select(dim, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_with_mirror_draws_moves_only_near_ties(seed):
    templates, gt, valid = small_scene(seed)
    kw = dict(vsx=24, vsy=20, **RF)
    sd = seeds(seed, seed + 50)
    draws = kernel_noise(sd, 20, 24, 6, 10)
    noisy = dense_assignment_reductions_reference(gt, valid, templates, sd, noise_tensor=draws, **kw)
    exact = dense_assignment_reductions_reference(gt, valid, templates, sd, noise=False, **kw)
    assert (noisy[0] - exact[0]).abs().max() <= VALUE_TOL
    assert (noisy[2] - exact[2]).abs().max() <= VALUE_TOL
    pert = perturbed_iou(gt, valid, templates, sd, noise=False, **kw)
    moved = noisy[1] != exact[1]
    assert (top2_gap(pert, 4)[moved] < GAP_TOL).all()
    moved_gt = noisy[3] != exact[3]
    assert (top2_gap(pert.reshape(2, -1, pert.shape[-1]), 1)[moved_gt] < GAP_TOL).all()
    assert moved.any()  # the noise does break the exact ties (anchors past every GT)


def test_twin_default_noise_is_seeded_per_image():
    """Without `noise_tensor` the twin draws torch.rand per image from a
    generator seeded with that image's seed: reproducible, independent of
    the batch, and not the kernel's hash."""
    templates, gt, valid = small_scene(3)
    kw = dict(vsx=24, vsy=20, **RF)
    sd = seeds(9, 4)
    pert = perturbed_iou(gt, valid, templates, sd, **kw)
    assert torch.equal(pert, perturbed_iou(gt, valid, templates, sd, **kw))
    assert torch.equal(pert[1], perturbed_iou(gt[1:], valid[1:], templates, sd[1:], **kw)[0])
    exact = perturbed_iou(gt, valid, templates, sd, noise=False, **kw)
    draw = torch.rand(exact.shape[1:], generator=torch.Generator().manual_seed(9))
    assert torch.equal(pert[0], torch.where(valid[0], exact[0] + 1e-6 * draw, -1.0))
    hashed = perturbed_iou(gt, valid, templates, sd, noise_tensor=kernel_noise(sd, 20, 24, 6, 10), **kw)
    assert not torch.equal(pert, hashed)


def test_bound_counts_valid_pairs():
    valid = torch.tensor([[1, 0, 1, 0, 0], [0, 0, 0, 1, 1]], dtype=torch.bool)  # holes
    assert valid_pairs(valid, 3, 4, 2) == 4 * 3 * 4 * 2
    # 96 pairs are nothing next to the 2 * 24 outputs: bytes bound it
    ms, by = k1_bound(valid, 3, 4, 2)
    nbytes = 2 * 5 * 16 + 2 * 5 + 2 * 16 + 2 * 4 + 2 * 24 * 8 + 2 * 5 * 8
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    # the train step's grid with 875 valid GTs of 2304 slots: operations
    big = torch.zeros(12, 192, dtype=torch.bool)
    big.view(-1)[torch.randperm(12 * 192, generator=torch.Generator().manual_seed(0))[:875]] = True
    ms, by = k1_bound(big, 63, 63, 25)
    assert by == "operations" and ms == pytest.approx(15 * 875 * 63 * 63 * 25 / 67e12 * 1e3, rel=1e-12)

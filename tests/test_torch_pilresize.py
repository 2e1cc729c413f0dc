"""The port's PIL-bilinear resize (ops/pilresize.py) and the fused pyramid's
resample="pil", on the CPU.

- The port's host oracle equals the JAX package's and PIL itself, byte for
  byte; the batched `resize_pil_batch` (float64, true sizes inside padded
  canvases, up- and downscales) equals the oracle byte for byte, and its
  weight matrices equal the oracle's bit for bit.
- Against the JAX package's float32 device version: within +-1 on < 1e-3
  of bytes, the JAX package's own bound (tests/test_pilresize.py).
- The fused pil pyramid against the port's host-resize path (PIL per
  level): boxes within 2e-2 px, scores within 5e-3 (tests/test_pilresize.py's
  tolerances); against the JAX PyramidDetector(resample="pil") with the
  same weights (utils/convert.from_jax, tests/test_torch_evaluation.py):
  identical survivors, boxes 1e-2 px, scores 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_evaluation import (EC, PROB, SCALES, TEMPLATES, TINY, assert_same_detections,
                                         detectors, images, shared_weights)
from tinyfaces_tpu.config import EvalConfig
from tinyfaces_tpu.ops import pilresize as jax_pil
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.ops import pilresize

SHAPES = [  # (h, w, oh, ow)
    (100, 140, 50, 70), (97, 131, 194, 262), (250, 250, 125, 125), (33, 47, 66, 94),
    (60, 80, 33, 44), (75, 75, 150, 150), (64, 64, 64, 64), (50, 70, 37, 52),
    (130, 97, 32, 24), (1, 7, 1, 3), (7, 3, 28, 12),
]


@pytest.mark.parametrize("h,w,oh,ow", SHAPES)
def test_host_oracle_equals_jax_and_pil(h, w, oh, ow):
    rng = np.random.default_rng(h * 1000 + w)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    got = pilresize.resize_pil_bilinear_np(img, oh, ow)
    np.testing.assert_array_equal(got, jax_pil.resize_pil_bilinear_np(img, oh, ow))
    np.testing.assert_array_equal(got, np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR)))
    np.testing.assert_array_equal(pilresize.pil_bilinear_matrix_np(oh, h),
                                  jax_pil.pil_bilinear_matrix_np(oh, h))


def test_weights_equal_the_oracle_bit_for_bit():
    rng = np.random.default_rng(0)
    pairs = [(int(rng.integers(1, 500)), int(rng.integers(1, 500))) for _ in range(60)]
    pairs += [(i, max(1, i >> 2)) for i in (5, 7, 63, 255, 511, 768, 1024)]  # the 2^-2 level
    pairs += [(i, 2 * i) for i in (1, 3, 383, 768)]  # the 2x level
    for in_size, out_size in pairs:
        in_pad, out_pad = in_size + int(rng.integers(0, 33)), out_size + int(rng.integers(0, 33))
        got = pilresize.pil_weights(in_pad, out_pad, torch.tensor([in_size]), torch.tensor([out_size]),
                                    pilresize.max_taps([in_size], [out_size]))[0].numpy()
        want = pilresize.pil_bilinear_matrix_np(out_size, in_size)
        assert np.array_equal(got[:out_size, :in_size], want), (in_size, out_size)
        assert not got[out_size:].any() and not got[:, in_size:].any()
    # the row sums are taken in NumPy's order, whatever the count of taps
    for n in range(1, 41):
        taps = torch.from_numpy(np.concatenate([rng.random(n), np.zeros(3)]))[None]
        assert pilresize._numpy_order_sum(taps, torch.tensor([n])).item() == taps[0, :n].numpy().sum()


def _canvases(rng, sizes, pad_hw):
    x = np.zeros((len(sizes), *pad_hw, 3), np.uint8)
    for b, (h, w) in enumerate(sizes):
        x[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
        x[b, h:], x[b, :, w:] = 123, 116  # padding the weights must ignore
    return x


@pytest.mark.parametrize("scale", ["down", "up", "mixed"])
def test_batch_byte_equal_to_the_oracle(scale):
    rng = np.random.default_rng(len(scale))
    sizes = [(50, 70), (97, 131), (33, 47), (128, 96)]
    levels = {"down": [(25, 35), (48, 65), (8, 11), (32, 24)],
              "up": [(100, 140), (194, 262), (66, 94), (256, 192)],
              "mixed": [(25, 140), (97, 131), (66, 23), (129, 95)]}[scale]
    x = _canvases(rng, sizes, (128, 160))
    out_hw = (272, 288)
    got = pilresize.resize_pil_batch(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.float32),
                                     out_hw, torch.tensor(sizes), torch.tensor(levels))
    assert got.dtype == torch.float64 and tuple(got.shape) == (4, 3, *out_hw)
    got = got.permute(0, 2, 3, 1).numpy()
    for b, ((h, w), (oh, ow)) in enumerate(zip(sizes, levels)):
        np.testing.assert_array_equal(got[b, :oh, :ow], pilresize.resize_pil_bilinear_np(x[b, :h, :w], oh, ow))
        assert not got[b, oh:].any() and not got[b, :, ow:].any()


def test_jax_device_version_within_one_lsb():
    rng = np.random.default_rng(7)
    tot = bad = 0
    for h, w, oh, ow in [(100, 140, 50, 70), (97, 131, 194, 262), (33, 47, 66, 94), (60, 80, 33, 44)]:
        x = _canvases(rng, [(h, w)], (h + 9, w + 17))
        got = pilresize.resize_pil_batch(torch.from_numpy(x).permute(0, 3, 1, 2), (oh + 5, ow + 3),
                                         torch.tensor([[h, w]]), torch.tensor([[oh, ow]]))
        got = got[0].permute(1, 2, 0).numpy().astype(np.int32)
        want = np.asarray(jax_pil.resize_pil_bilinear(
            jnp.asarray(x[0], jnp.float32), (oh + 5, ow + 3), (jnp.int32(oh), jnp.int32(ow)),
            (jnp.int32(h), jnp.int32(w)))).astype(np.int32)
        d = np.abs(got - want)
        assert d.max() <= 1
        tot += d.size
        bad += int((d > 0).sum())
    assert bad / tot < 1e-3, (bad, tot)


def _pil_pair(ec=None):
    ec = ec or EvalConfig(max_dets_per_scale=50, max_total_dets=50, resample="pil")
    return detectors(*shared_weights(), ec=ec)


@pytest.mark.parametrize("hw", [(128, 256), (256, 128), (256, 256)])
def test_fused_pil_matches_host_resize_path(hw):
    """The fused pil pyramid against the port's host path, which resizes
    each level with PIL itself. Both pad a level past its true size, the
    fused path (as the JAX package) with pixel 0 inside its 32-px canvas,
    the host path with the mean pixel inside its bucket; at sizes whose
    levels fill both (multiples of 128, scales -1..1) they see the same
    pixels and must agree at tests/test_pilresize.py's tolerances."""
    _, det = _pil_pair(EvalConfig(resample="pil"))
    img = np.random.default_rng(hw[0] + hw[1]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = det.detect(img, 0.05, 0.3, scales=SCALES, host_resize=True)
    got = det.detect_batch([img], 0.05, 0.3, scales=SCALES)[0]
    assert got.shape == ref.shape and ref.shape[0] > 100
    # rows pair one to one (two rows whose scores tie may swap places)
    free = np.ones(len(got), bool)
    for row in ref:
        near = free & (np.abs(got[:, :4] - row[:4]).max(1) <= 2e-2) & (np.abs(got[:, 4] - row[4]) <= 5e-3)
        assert near.any(), row
        free[np.argmax(near)] = False


@pytest.mark.parametrize("scales", [SCALES, (-2, -1, 0, 1)])
def test_pil_pyramid_matches_jax(scales):
    """Padded canvases (3 images, 2 buckets), so the levels' zero padding is
    held too. At the octave scales the JAX package's float32 weights land on
    the exact grid; at half octaves they flip +-1 on ~0.1-0.6% of bytes
    against PIL (its documented deviation), which the port does not share:
    there the bytes are held against the oracle instead
    (test_batch_byte_equal_to_the_oracle, "mixed")."""
    jd, td = _pil_pair()
    assert jd.ec.resample == td.ec.resample == "pil"
    imgs = images()
    want = jd.detect_batch(imgs, prob_thresh=PROB, scales=scales)
    got = td.detect_batch(imgs, prob_thresh=PROB, scales=scales)
    assert sum(w.shape[0] for w in want) > 20
    for g, w in zip(got, want):
        assert_same_detections(g, w)


def test_pil_needs_the_rgb_wire():
    model = TinyFacesDetector(stage_sizes=TINY)
    ec = EvalConfig(resample="pil")
    with pytest.raises(ValueError, match="transfer='rgb'"):
        evaluation.PyramidDetector(model, TEMPLATES, ec=ec, device="cpu", transfer="jpegdct")
    assert EC.resample == "linear"

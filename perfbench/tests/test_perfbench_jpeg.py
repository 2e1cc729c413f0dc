"""The harness's JPEG encoder writes files that a library decoder reads as
its exact decode says, within the library's integer rounding."""

import numpy as np
import pytest

from perfbench.drivers._shared import rng
from perfbench.tests.tiny import decode_jpeg
from perfbench.traffic import generate, jpeg



@pytest.mark.parametrize("hw", [(96, 160), (101, 157)])
def test_encoder_round_trip(hw):
    image = generate.natural_image(rng(4, 1), *hw)
    data, co = jpeg.encode(image, 90)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    assert jpeg.encode(image, 90)[0] == data
    exact = jpeg.decode(co)
    pil = decode_jpeg(data).astype(np.float64)
    assert pil.shape == exact.shape == image.shape
    assert np.abs(pil - exact).max() <= 4.0 and np.abs(pil - exact).mean() < 1.0
    assert np.abs(exact - image).mean() < 2.0  # what q90 loses


def test_exact_pool_keeps_coefficients():
    made = generate.jpeg_pool(rng(5, 1), 2, [97, 127], [161, 191], 90)
    again = generate.jpeg_pool(rng(5, 1), 2, [97, 127], [161, 191], 90)
    assert [m[0] for m in made] == [m[0] for m in again]
    for data, co in made:
        assert decode_jpeg(data).shape == jpeg.decode(co).shape


def test_huffman_tables_are_valid():
    bits, vals, codes = jpeg._huffman(np.bincount([0, 0, 0, 1, 2, 2, 5], minlength=256))
    assert sum(bits) == len(vals) == 4 and max(length for _, length in codes.values()) <= 16
    lengths = sorted(codes.values(), key=lambda c: c[1])
    assert all(code != (1 << length) - 1 for code, length in lengths)  # no all-ones code

"""The port's per-image pyramid resize against
`jax.image.scale_and_translate(linear, antialias=True)`, the fused JAX
pyramid's resize (tinyfaces_tpu/evaluation.py:363-370), on normalised
mean-padded canvases. Per image the scale is level size over true size,
applied to the whole canvas; atol 1e-5 on normalised values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tinyfaces_tpu_torch.data.targets import normalize_images
from tinyfaces_tpu_torch.data.wider_face import MEAN_PIXEL
from tinyfaces_tpu_torch.ops.resize import resize_batch


def _canvas(rng, sizes, hp, wp):
    x = np.empty((len(sizes), hp, wp, 3), np.uint8)
    x[:] = MEAN_PIXEL
    for i, (h, w) in enumerate(sizes):
        x[i, :h, :w] = rng.integers(0, 256, (h, w, 3))
    return x


def _jax_resize(img, out_hw, size, level):
    scale = jnp.stack([jnp.float32(level[0]) / jnp.float32(size[0]),
                       jnp.float32(level[1]) / jnp.float32(size[1])])
    return jax.image.scale_and_translate(img, (*out_hw, 3), (0, 1), scale, jnp.zeros(2, jnp.float32),
                                         method="linear", antialias=True)


@pytest.mark.parametrize("factor", [0.25, 0.5, 2**-0.5, 1.0, 2.0])
def test_resize_matches_scale_and_translate(factor):
    rng = np.random.default_rng(int(factor * 100))
    sizes = [(37, 53), (61, 29), (64, 64)]  # odd sizes in a 64x64 canvas
    hp = wp = 64
    u8 = _canvas(rng, sizes, hp, wp)
    levels = [(max(1, int(h * factor)), max(1, int(w * factor))) for h, w in sizes]
    out_hw = (max(32, int(round(hp * factor)) + 31) // 32 * 32,
              max(32, int(round(wp * factor)) + 31) // 32 * 32)

    x = normalize_images(torch.from_numpy(u8)).permute(0, 3, 1, 2).contiguous()
    got = resize_batch(x, out_hw, torch.tensor(sizes), torch.tensor(levels)).permute(0, 2, 3, 1)

    xn = np.asarray(x.permute(0, 2, 3, 1))
    want = np.stack([np.asarray(_jax_resize(jnp.asarray(xn[i]), out_hw, sizes[i], levels[i]))
                     for i in range(len(sizes))])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    if factor == 1.0:  # the identity is exact (the fused pyramid skips it)
        np.testing.assert_array_equal(got[2].numpy(), xn[2])

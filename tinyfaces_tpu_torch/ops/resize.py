"""Per-image antialiased linear resize of padded canvases, as batched matmuls.

The fused pyramid of tinyfaces_tpu/evaluation.py:363-370 resizes each
image's whole mean-padded canvas with

    jax.image.scale_and_translate(img, (thp, twp, 3), (0, 1),
                                  scale=(th/h0, tw/w0), translation=0,
                                  method="linear", antialias=True)

where (h0, w0) is the image's true size and (th, tw) its level size, so the
scale differs per image while the canvas shapes are shared by the batch.
This module builds the same (out, in) weight matrix per image and axis —
a triangle kernel on half-pixel centres, its support widened by 1/scale
when downscaling, each output's weights normalised over the taps that land
in the canvas, and outputs whose centre maps outside the canvas zeroed —
in float32 with JAX's operation order, and applies the two axes as two
batched matmuls. `F.interpolate(antialias=True)` differs from it at the
borders and at non-integer scales, so it is not used.
"""

from __future__ import annotations

import numpy as np
import torch


def resize_weights(in_size: int, out_size: int, scale: torch.Tensor) -> torch.Tensor:
    """(B, out_size, in_size) float32 weights for per-image scales (B,)
    float32 (output size over input size of the valid region)."""
    dev = scale.device
    inv_scale = 1.0 / scale[:, None, None]
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    out_pos = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :, None]
    sample_f = (out_pos + 0.5) * inv_scale - 0.5  # translation is 0
    in_pos = torch.arange(in_size, dtype=torch.float32, device=dev)[None, None, :]
    x = torch.abs(sample_f - in_pos) / kernel_scale
    weights = torch.clamp_min(1.0 - torch.abs(x), 0.0)  # triangle kernel
    total = weights.sum(dim=2, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside, weights, 0.0)


def resize_batch(x: torch.Tensor, out_hw: tuple[int, int], size_hw: torch.Tensor,
                 level_hw: torch.Tensor) -> torch.Tensor:
    """Resize each canvas of x (B, C, H, W) to out_hw, image i by the
    factors level_hw[i] / size_hw[i] ((B, 2) integer tensors of the level
    size and the true size). Weights take x's dtype, as JAX casts them to
    the image's dtype."""
    sizes = size_hw.to(torch.float32)
    levels = level_hw.to(torch.float32)
    wh = resize_weights(x.shape[2], out_hw[0], levels[:, 0] / sizes[:, 0]).to(x.dtype)
    ww = resize_weights(x.shape[3], out_hw[1], levels[:, 1] / sizes[:, 1]).to(x.dtype)
    y = torch.matmul(wh[:, None], x)  # rows: (B, C, out_h, W)
    return torch.matmul(y, ww[:, None].transpose(2, 3))  # columns: (B, C, out_h, out_w)

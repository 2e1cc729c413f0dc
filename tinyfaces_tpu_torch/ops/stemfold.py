"""The exact-2x bilinear upsample folded into the ResNet stem conv.

Port of tinyfaces_tpu/ops/stemfold.py in NCHW with (O, C, kh, kw) weights.
The pyramid's 2x level resizes each canvas by exactly 2.0 (an integer short
side h goes to 2h) and convolves it with the 7x7 stride-2 stem. Both are
linear and period-2 translation-invariant, so their composition is one 5x5
stride-1 convolution on the 1x canvas:

    stem_s2(upsample_2x(x)) == conv_s1(x, K5),
    K5[o, c, a, b] = sum_{k, l} G[k, a] G[l, b] w7[o, c, k, l],

where G[k, d+2] is the weight of x[n+d] in the upsampled row 2n+k-3 that
stem tap k reads. The (B, 3, 2H, 2W) canvas, the largest tensor of the
pyramid, is never made, and the stem does 25 taps an output instead of 49.

Borders: the resize renormalises its weights at the canvas edge and the
composite's zero padding lies in the 1x domain, not the 2x one, so within
two output pixels of each edge the fold differs from resize-then-conv. Those
two rows and columns on each side are recomputed the unfolded way from
6-pixel bands (upsampled by ops/resize.py's own weights, edge
renormalisation included, which falls only on band rows that are thrown
away) and pasted over the fold: rows first, then full-height columns, which
also fixes the corners. The result equals resize-then-conv up to summation
order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tinyfaces_tpu_torch.data.targets import device_constant
from tinyfaces_tpu_torch.ops.resize import resize_weights

# G[k, d+2]: coefficient of x[n+d] inside u[2n+k-3], for stem tap k = 0..6.
# The upsample at scale 2.0 maps output m to input (m+0.5)/2 - 0.5:
# u[2t] = 0.25 x[t-1] + 0.75 x[t], u[2t+1] = 0.75 x[t] + 0.25 x[t+1].
PHASE_G = np.zeros((7, 5), np.float64)
for _k in range(7):
    _m = _k - 3  # u offset relative to 2n
    _t = _m // 2
    if _m % 2 == 0:  # u[2t]
        PHASE_G[_k, _t - 1 + 2] += 0.25
        PHASE_G[_k, _t + 2] += 0.75
    else:  # u[2t+1]
        PHASE_G[_k, _t + 2] += 0.75
        PHASE_G[_k, _t + 1 + 2] += 0.25
del _k, _m, _t


def fold_stem_kernel(w7: torch.Tensor) -> torch.Tensor:
    """(O, C, 7, 7) stride-2 stem weights -> (O, C, 5, 5) folded stride-1
    weights, in float32."""
    g = device_constant(tuple(map(tuple, PHASE_G.tolist())), torch.float32, w7.device)
    return torch.einsum("ka,lb,ockl->ocab", g, g, w7.to(torch.float32))


def _upsample2x(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Exact-2x upsample of (B, C, h, w) to out_hw with the pyramid's own
    per-axis weights (ops/resize.py at scale 2.0), in x's dtype."""
    two = torch.full((1,), 2.0, dtype=torch.float32, device=x.device)
    wh = resize_weights(x.shape[2], out_hw[0], two)[0].to(x.dtype)
    ww = resize_weights(x.shape[3], out_hw[1], two)[0].to(x.dtype)
    return torch.matmul(torch.matmul(wh, x), ww.t())


def folded_stem_2x(x: torch.Tensor, w7: torch.Tensor) -> torch.Tensor:
    """conv1 (7x7/2, pad 3) of the exact-2x upsampled canvas, computed at 1x.

    x: (B, C, H, W) normalized canvas in the model's compute dtype (H, W >=
    6). w7: (O, C, 7, 7) stem weights (any float dtype; folded in float32,
    then cast to x's dtype). Returns (B, O, H, W)."""
    dtype = x.dtype
    h, w = x.shape[2], x.shape[3]
    w7d = w7.to(dtype)
    y = F.conv2d(x, fold_stem_kernel(w7).to(dtype), padding=2)

    def stem(u, pad):  # pad: (left, right, top, bottom) zero padding of u
        return F.conv2d(F.pad(u, pad), w7d, stride=2)

    # Rows 0..1 read u rows -3..5 (zero padding above), rows H-2..H-1 read
    # u rows 2H-7..2H+1 (zero padding below): a 6-row band upsampled to 12
    # covers each, its own renormalised edge falling on an unused row.
    y[:, :, 0:2] = stem(_upsample2x(x[:, :, :6], (12, 2 * w))[:, :, 0:6], (3, 3, 3, 0))
    y[:, :, h - 2:h] = stem(_upsample2x(x[:, :, h - 6:], (12, 2 * w))[:, :, 5:12], (3, 3, 0, 3))
    # Full-height column bands are exact in both directions, so pasting them
    # last fixes the four corners as well.
    y[:, :, :, 0:2] = stem(_upsample2x(x[:, :, :, :6], (2 * h, 12))[..., 0:6], (3, 0, 3, 3))
    y[:, :, :, w - 2:w] = stem(_upsample2x(x[:, :, :, w - 6:], (2 * h, 12))[..., 5:12], (0, 3, 3, 3))
    return y

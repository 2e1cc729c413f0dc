"""Tiny-faces detection model: ResNet FCN + 25-template hybrid heads.

Port of tinyfaces_tpu/models/detection.py:
  * score_res3: 1x1 conv 512 -> (1+4)*T channels, score_res4: 1x1 conv
    1024 -> (1+4)*T, both with bias;
  * score_res4 upsampled 2x by a frozen, bilinear-initialised depthwise
    ConvTranspose(k=4, s=2, p=1), cropped to res3's grid `[:h3, :w3]`, and
    added to score_res3.

Layout contract of the JAX package at the boundary: input (B, H, W, 3),
output (B, H/8, W/8, 5T) float32, channels [0:T) template logits and
[T:5T) regression as tx|ty|tw|th blocks. Inside, the model runs NCHW; a
permuted NHWC input is a channels_last NCHW tensor, so no copy is made.

`dtype` (models/resnet.py) sets the activation dtype; the heads and the
upsample run in it too, and the output is float32 whatever it is, as in
the JAX model, so decode and NMS always see float32. `remat=True`
recomputes each bottleneck's activations in the backward pass
(models/resnet.py), as the JAX model's `remat`. `stem_precomputed=True`
takes conv1's output, (B, 64, H/2, W/2) NCHW, in place of the image and
starts at bn1: the pyramid's folded 2x stem (ops/stemfold.py) computes it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinyfaces_tpu_torch.models.resnet import BatchNorm2d, Conv2d, RESNET101_STAGES, ResNetBackbone


def bilinear_kernel_1d(k: int) -> np.ndarray:
    """The 1-D bilinear filter of the reference's _init_bilinear
    (model.py:45-65). k=4 -> [0.25, 0.75, 0.75, 0.25]."""
    factor = np.floor((k + 1) / 2)
    center = factor if k % 2 == 1 else factor + 0.5
    taps = np.arange(1, k + 1)
    return 1.0 - np.abs(taps - center) / factor


class DepthwiseConvTranspose2x(nn.Module):
    """Frozen depthwise ConvTranspose(k=4, s=2, p=1): exact 2x upsampling.
    The weight is (C, 1, 4, 4), one bilinear filter per channel."""

    def __init__(self, channels: int, kernel_size: int = 4):
        super().__init__()
        vec = bilinear_kernel_1d(kernel_size)
        kern = np.broadcast_to(np.outer(vec, vec), (channels, 1, kernel_size, kernel_size))
        self.weight = nn.Parameter(torch.tensor(kern, dtype=torch.float32), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(x, self.weight.to(x.dtype), stride=2, padding=1, groups=x.shape[1])


class TinyFacesDetector(nn.Module):
    """The flagship model: FCN face detector with 25 anchor templates."""

    def __init__(self, num_templates: int = 25, num_objects: int = 1,
                 stage_sizes: Sequence[int] = RESNET101_STAGES,
                 dtype: torch.dtype | None = None, remat: bool = False):
        super().__init__()
        self.num_templates = num_templates
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        out = (num_objects + 4) * num_templates
        self.model = ResNetBackbone(stage_sizes, dtype, remat)
        self.score_res3 = Conv2d(512, out, 1)
        self.score_res4 = Conv2d(1024, out, 1)
        self.score4_upsample = DepthwiseConvTranspose2x(out)

    def forward(self, x: torch.Tensor, stem_precomputed: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/8, W/8, 5T) float32; with stem_precomputed,
        conv1's (B, 64, H/2, W/2) -> the same."""
        res3, res4 = self.model(x if stem_precomputed else x.permute(0, 3, 1, 2),
                                stem_precomputed=stem_precomputed)
        score3 = self.score_res3(res3)
        score4 = self.score4_upsample(self.score_res4(res4))
        # Top-left crop to res3's grid (reference model.py:107-124).
        score4 = score4[:, :, : score3.shape[2], : score3.shape[3]]
        return (score3 + score4).permute(0, 2, 3, 1).float()


def init_model(model: TinyFacesDetector, generator: torch.Generator) -> TinyFacesDetector:
    """Fresh weights drawn from `generator`, as flax initialises the JAX
    model: LeCun-normal conv kernels, zero biases, unit BN scale, zero BN
    shift, identity running statistics; the upsample keeps its bilinear
    filter."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model

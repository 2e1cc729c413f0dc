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
starts at bn1: the pyramid's folded 2x stem (ops/stemfold.py) computes it
(the ResNet backbones only).

`ARCHS` is the registry of backbones `arch` names: for each, the backbone,
the channels of its stride-8 and stride-16 maps (what `score_res3` and
`score_res4` read), its receptive-field geometry and its native input
size. `resnet101` and `resnet50` are the paper's ResNets truncated after
res4 (`stage_sizes` builds any other depth); `vitdet_b` is ViTDet-B with
its simple feature pyramid (models/vitdet.py), whose stride-8 and
stride-16 levels stand where res3 and res4 stand. `detector_config(arch)`
is the DetectorConfig of an architecture at its native input.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tinyfaces_tpu_torch.config import DetectorConfig, ReceptiveField
from tinyfaces_tpu_torch.models.resnet import ARCH_STAGES, BatchNorm2d, Conv2d, RESNET101_STAGES, ResNetBackbone
from tinyfaces_tpu_torch.models.vitdet import VITDET_B, LayerNorm2d, VitDetBackbone


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


@dataclasses.dataclass(frozen=True)
class Arch:
    """One backbone of the registry: `build(stage_sizes, dtype, remat)`
    makes it; `channels` of its (stride-8, stride-16) maps; `rf` the
    receptive-field geometry of the stride-8 score map (data/targets.py and
    K1 place the anchors by its stride and offset); `input_size` its native
    square input; `stages` a ResNet's blocks per stage (None for a backbone
    that is no ResNet: no remat, folded stem or eval pyramid)."""

    build: Callable[..., nn.Module]
    channels: tuple[int, int]
    rf: ReceptiveField
    input_size: int
    stages: Optional[tuple[int, ...]] = None


def _vit_backbone(stage_sizes, dtype, remat):
    return VitDetBackbone(VITDET_B, dtype)


# vitdet_b's geometry (derived in perfbench/configs/tinyfaces-vitdet-b-train-bf16.json):
# patch j covers pixels 16j..16j+15, the 2x2/2 transposed conv gives p3 cell
# i = 2j + k pixels 8i..8i+7, whose centre in the port's inclusive pixel
# convention (a box's centre (x1 + x2) / 2) is 8i + 3.5. Every token sees the
# whole image through the global blocks, so the field's size is the input's.
ARCHS: dict = {
    **{name: Arch(ResNetBackbone, (512, 1024), ReceptiveField(), 500, stages)
       for name, stages in ARCH_STAGES.items()},
    "vitdet_b": Arch(_vit_backbone, (VITDET_B.pyramid_dim, VITDET_B.pyramid_dim),
                     ReceptiveField(size=(VITDET_B.img_size,) * 2, stride=(8, 8), offset=(3.5, 3.5)),
                     VITDET_B.img_size),
}


def detector_config(arch: str, **fields) -> DetectorConfig:
    """The DetectorConfig of `arch` at its native input: that input, a heat
    map of a cell per 8 pixels and its receptive field (the ResNets':
    DetectorConfig's defaults, 500x500, 63x63, the reference's field).
    `fields` override."""
    a = ARCHS[arch]
    s = a.input_size
    return DetectorConfig(**{"input_size": (s, s), "heatmap_size": (-(-s // 8),) * 2, "rf": a.rf,
                             **fields})


class TinyFacesDetector(nn.Module):
    """The flagship model: FCN face detector with 25 anchor templates.
    `arch` names a backbone of `ARCHS`; without it `stage_sizes` builds a
    ResNet (resnet101's by default)."""

    def __init__(self, num_templates: int = 25, num_objects: int = 1,
                 stage_sizes: Sequence[int] = RESNET101_STAGES,
                 dtype: torch.dtype | None = None, remat: bool = False,
                 arch: Optional[str] = None):
        super().__init__()
        if arch is not None and arch not in ARCHS:
            raise ValueError(f"unknown architecture {arch!r}; use one of {tuple(ARCHS)}")
        self.arch = arch or "resnet101"
        spec = ARCHS[self.arch]
        if arch is not None and spec.stages is not None:
            stage_sizes = spec.stages
        if remat and spec.stages is None:
            raise ValueError(f"remat is built for the ResNet backbones only, not {self.arch}")
        self.num_templates = num_templates
        self.stage_sizes = tuple(stage_sizes)
        self.dtype = dtype
        out = (num_objects + 4) * num_templates
        self.model = spec.build(stage_sizes, dtype, remat)
        self.score_res3 = Conv2d(spec.channels[0], out, 1)
        self.score_res4 = Conv2d(spec.channels[1], out, 1)
        self.score4_upsample = DepthwiseConvTranspose2x(out)

    def forward(self, x: torch.Tensor, stem_precomputed: bool = False) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H/8, W/8, 5T) float32; with stem_precomputed,
        conv1's (B, 64, H/2, W/2) -> the same (ResNet only)."""
        if ARCHS[self.arch].stages is None:
            if stem_precomputed:
                raise ValueError(f"stem_precomputed is the ResNet stem's; {self.arch} has none")
            res3, res4 = self.model(x.permute(0, 3, 1, 2))
        else:
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
    filter. A ViT's as ViTDet initialises it: linear weights and the
    position embedding trunc-normal with std 0.02, unit LayerNorm scales
    and zero shifts, zero relative-position tables; its convolutions
    LeCun-normal (a transposed conv's fan-in its input channels per output
    pixel)."""
    std = 0.02
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel()
                if isinstance(m, nn.ConvTranspose2d):
                    fan_in = m.in_channels * m.weight[0, 0].numel() // (m.stride[0] * m.stride[1])
                m.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
                m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif hasattr(m, "pos_embed"):
                nn.init.trunc_normal_(m.pos_embed, std=std, a=-2 * std, b=2 * std, generator=generator)
            elif hasattr(m, "rel_pos_h"):
                m.rel_pos_h.zero_()
                m.rel_pos_w.zero_()
    return model

"""The detector as plain functions over a dict of named tensors.

ResNet-101 (torchvision v1.5 bottlenecks: 1x1, 3x3 with the stride, 1x1 x4,
projection shortcut where the shape changes) truncated after res4, with
batch norm (eps 1e-5); `score_res3` and `score_res4` 1x1 heads with biases;
`score_res4` upsampled 2x by a frozen depthwise 4x4/2 transposed conv with
the bilinear filter, cropped to res3's grid and added. Names follow the
reference PyTorch model (`model.conv1.weight`, `model.layer3.22.bn2.bias`,
`score_res3.weight`, ...), so one dict of weights serves both sides.

`quant`, if given, rounds every tensor where a low-precision run of the
detector stores one: the input, each weight, each convolution's, batch
norm's, sum's and head's output (the control's lower precision); `train`
normalises with the batch's biased statistics.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

STAGES_R101 = (3, 4, 23)
WIDTHS = (64, 128, 256)
BN_EPS = 1e-5


def blocks(stages: Sequence[int]):
    """(prefix, in_ch, width, stride, has_projection) of every bottleneck."""
    cin = 64
    for si, (n, width) in enumerate(zip(stages, WIDTHS)):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            yield f"model.layer{si + 1}.{bi}", cin, width, stride, stride != 1 or cin != 4 * width
            cin = 4 * width


def param_shapes(stages: Sequence[int] = STAGES_R101, templates: int = 25) -> dict:
    """name -> shape of every weight, bias and batch-norm statistic."""
    shapes = {"model.conv1.weight": (64, 3, 7, 7)}

    def bn(prefix, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{prefix}.{k}"] = (c,)

    bn("model.bn1", 64)
    for p, cin, width, _, proj in blocks(stages):
        shapes[f"{p}.conv1.weight"] = (width, cin, 1, 1)
        bn(f"{p}.bn1", width)
        shapes[f"{p}.conv2.weight"] = (width, width, 3, 3)
        bn(f"{p}.bn2", width)
        shapes[f"{p}.conv3.weight"] = (4 * width, width, 1, 1)
        bn(f"{p}.bn3", 4 * width)
        if proj:
            shapes[f"{p}.downsample.0.weight"] = (4 * width, cin, 1, 1)
            bn(f"{p}.downsample.1", 4 * width)
    out = 5 * templates
    shapes.update({"score_res3.weight": (out, 512, 1, 1), "score_res3.bias": (out,),
                   "score_res4.weight": (out, 1024, 1, 1), "score_res4.bias": (out,),
                   "score4_upsample.weight": (out, 1, 4, 4)})
    return shapes


def bilinear_filter(channels: int, device=None) -> torch.Tensor:
    """(C, 1, 4, 4) filter of exact 2x bilinear upsampling by a 4x4/2
    transposed conv: the outer product of [0.25, 0.75, 0.75, 0.25]."""
    v = torch.tensor([0.25, 0.75, 0.75, 0.25], device=device)
    return torch.outer(v, v).expand(channels, 1, 4, 4).contiguous()


class Detector:
    """forward(x) for NCHW float32 x -> (B, 5T, H/8, W/8) float32 logits
    and regressions. `stats`, if a dict, collects each batch norm's batch
    (mean, biased variance) in train mode."""

    def __init__(self, weights: dict, stages: Sequence[int] = STAGES_R101,
                 quant: Optional[Callable] = None):
        self.w = weights
        self.stages = tuple(stages)
        self.quant = quant

    def q(self, x):
        return x if self.quant is None else self.quant(x)

    def conv(self, x, name, stride=1, pad=0, bias=None):
        w = self.q(self.w[name])
        return self.q(F.conv2d(x, w, None if bias is None else self.q(bias), stride, pad))

    def bn(self, x, prefix, train, stats):
        w = self.w
        if train:
            if stats is not None:
                var, mean = torch.var_mean(x.detach(), dim=(0, 2, 3), correction=0)
                stats[prefix] = (mean, var)
            return F.batch_norm(x, None, None, w[prefix + ".weight"], w[prefix + ".bias"],
                                True, 0.0, BN_EPS)
        return self.q(F.batch_norm(x, w[prefix + ".running_mean"], w[prefix + ".running_var"],
                                   w[prefix + ".weight"], w[prefix + ".bias"], False, 0.0, BN_EPS))

    def forward(self, x: torch.Tensor, train: bool = False, stats: Optional[dict] = None) -> torch.Tensor:
        y = self.conv(self.q(x), "model.conv1.weight", 2, 3)
        y = F.relu(self.bn(y, "model.bn1", train, stats))
        y = F.max_pool2d(y, 3, 2, 1)
        res = []
        for p, _, _, stride, proj in blocks(self.stages):
            if p.endswith(".0") and p != "model.layer1.0":
                res.append(y)
            idt = y
            if proj:
                idt = self.bn(self.conv(y, p + ".downsample.0.weight", stride), p + ".downsample.1",
                              train, stats)
            z = F.relu(self.bn(self.conv(y, p + ".conv1.weight"), p + ".bn1", train, stats))
            z = F.relu(self.bn(self.conv(z, p + ".conv2.weight", stride, 1), p + ".bn2", train, stats))
            z = self.bn(self.conv(z, p + ".conv3.weight"), p + ".bn3", train, stats)
            y = F.relu(self.q(z + idt))
        res3, res4 = res[-1], y
        s3 = self.conv(res3, "score_res3.weight", bias=self.w["score_res3.bias"])
        s4 = self.conv(res4, "score_res4.weight", bias=self.w["score_res4.bias"])
        up = self.w["score4_upsample.weight"]
        s4 = self.q(F.conv_transpose2d(s4, self.q(up), stride=2, padding=1, groups=s4.shape[1]))
        return self.q(s3 + s4[:, :, : s3.shape[2], : s3.shape[3]])


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, and back: a tensor stored in fp8."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

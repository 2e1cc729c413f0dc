"""The weights both sides run, made on the device from the seed.

`make` draws every convolution kernel LeCun-normal (std fan_in**-0.5) from
one torch.Generator on the device in one call, zero biases, unit batch-norm
scales, zero shifts, identity running statistics, and the upsample's
bilinear filter: the flax initialisation the port's own `init_model`
follows, but drawn here; except that each bottleneck's last batch norm
scales its branch by BRANCH_SCALE (0.2). A trained ResNet's residual
branches are damped so (and zero-init-residual training starts them at 0);
at 1.0 the seeded ResNet-101 is chaotic: rounding of 2**-12 at every
stored tensor moves its logits by 0.16 at the median, and fp8 moves them
only twice as far as bf16, where at 0.2 the errors scale with the
rounding (ten times bf16's for fp8). `calibrate` then gives the seeded detector a
trained detector's output range (the eval cells' set-up).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.model import Detector, bilinear_filter, param_shapes
from perfbench.reference.pyramid import normalised


def torch_seed(seed: int, *key: int) -> int:
    """A 63-bit torch seed from the run's seed and a key."""
    return int(np.random.SeedSequence([seed % 2**63, *key]).generate_state(1, np.uint64)[0] >> 1)


BRANCH_SCALE = 0.2


def make(seed: int, device, stages: Sequence[int], templates: int = 25) -> dict:
    shapes = param_shapes(stages, templates)
    convs = [n for n, s in shapes.items() if len(s) == 4 and n != "score4_upsample.weight"]
    sizes = [math.prod(shapes[n]) for n in convs]
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 0xBEEF))
    flat = torch.empty(sum(sizes), device=device).normal_(generator=gen)
    out = {}
    for n, part in zip(convs, torch.split(flat, sizes)):
        shape = shapes[n]
        out[n] = (part.view(shape) * math.prod(shape[1:]) ** -0.5).contiguous()
    for n, s in shapes.items():
        if n in out:
            continue
        if n == "score4_upsample.weight":
            out[n] = bilinear_filter(s[0], device)
        elif n.endswith(".bn3.weight"):
            out[n] = torch.full(s, BRANCH_SCALE, device=device)
        elif n.endswith("running_var") or (n.endswith(".weight") and len(s) == 1):
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    return out


@torch.no_grad()
def calibrate(weights: dict, images: list, device, stages: Sequence[int], *, templates: int,
              prob_thresh: float, fraction: float, levels=(-1, 0, 1), max_logit: float = 10.0) -> list:
    """In place: batch-norm running statistics become the mean over
    `levels` of the batch statistics of `images` (decoded uint8, cropped to
    the smallest); regression weights shrink to 1% (exp(tw) stays near 1);
    class weights scale so the largest logit is `max_logit`; class biases
    shift so `fraction` of the cells of templates 4..11 clear prob_thresh.
    `images` are (H, W, 3) in [0, 255]. Returns the count of such cells per
    image at each level."""
    h = min(im.shape[0] for im in images)
    w = min(im.shape[1] for im in images)
    x = torch.cat([normalised(np.ascontiguousarray(im[:h, :w]), device) for im in images])
    xs = [F.interpolate(x, scale_factor=2.0 ** s, mode="bilinear", antialias=s < 0) for s in levels]
    model = Detector(weights, stages)
    sums: dict = {}
    for xl in xs:
        stats: dict = {}
        model.forward(xl, train=True, stats=stats)
        for k, (m, v) in stats.items():
            a, b = sums.get(k, (0.0, 0.0))
            sums[k] = (a + m, b + v)
    for k, (m, v) in sums.items():
        weights[k + ".running_mean"] = m / len(xs)
        weights[k + ".running_var"] = v / len(xs)
    t = templates
    for head in ("score_res3", "score_res4"):
        weights[head + ".weight"][t:] *= 0.01
    logits = [model.forward(xl)[:, 4:12] for xl in xs]
    gain = max_logit / max(float(g.abs().max()) for g in logits)
    for head in ("score_res3", "score_res4"):
        weights[head + ".weight"][:t] *= gain
    flat = torch.cat([g.flatten() for g in logits]) * gain
    k = max(1, int(round((1 - fraction) * flat.numel())))
    shift = math.log(prob_thresh / (1 - prob_thresh)) - float(flat.kthvalue(k).values)
    weights["score_res3.bias"][:t] += shift
    thr = math.log(prob_thresh / (1 - prob_thresh))
    return [int(((g * gain + shift) > thr).sum()) // len(images) for g in logits]

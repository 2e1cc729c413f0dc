"""FLOP count of the published detector from its shapes alone.

The architecture of Hu & Ramanan's detector (arXiv:1612.04402; the
reference `varunagrawal/tiny-faces-pytorch`): ResNet-101 (torchvision v1.5
bottlenecks, stride on the 3x3) truncated after res4, `score_res3` (1x1,
512 -> 5T) and `score_res4` (1x1, 1024 -> 5T) with biases, and a frozen
depthwise 4x4/2 transposed conv that upsamples `score_res4` 2x. The 7x7/2
stem is counted unfolded, as the reference computes it, whatever stem the
port runs.

Counting follows `torch.utils.flop_counter`'s convention, to which a test
ties it: 2 FLOPs a multiply-add of every convolution, nothing for batch
norm, ReLU, pooling or adds. A train step adds the gradient of every
convolution's input (not the image's) and of every trainable weight (not the
frozen upsample's).
"""

from __future__ import annotations

from typing import Iterator, Sequence

STAGES_R101 = (3, 4, 23)
WIDTHS = (64, 128, 256)


def _out(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def convs(hw: Sequence[int], stages: Sequence[int] = STAGES_R101,
          templates: int = 25) -> Iterator[tuple]:
    """(name, cin_per_group, cout, k, out_hw, in_hw, transposed) of every
    convolution of one forward on an (H, W) input."""
    h, w = hw
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    yield "conv1", 3, 64, 7, (h, w), hw, False
    h, w = _out(h, 3, 2, 1), _out(w, 3, 2, 1)  # max pool
    cin = 64
    res = []
    for si, (n, width) in enumerate(zip(stages, WIDTHS)):
        for bi in range(n):
            stride = 2 if si > 0 and bi == 0 else 1
            ho, wo = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            yield f"layer{si + 1}.{bi}.conv1", cin, width, 1, (h, w), (h, w), False
            yield f"layer{si + 1}.{bi}.conv2", width, width, 3, (ho, wo), (h, w), False
            yield f"layer{si + 1}.{bi}.conv3", width, 4 * width, 1, (ho, wo), (ho, wo), False
            if stride != 1 or cin != 4 * width:
                yield f"layer{si + 1}.{bi}.downsample", cin, 4 * width, 1, (ho, wo), (h, w), False
            cin, h, w = 4 * width, ho, wo
        res.append((h, w))
    out = 5 * templates
    yield "score_res3", 512, out, 1, res[1], res[1], False
    yield "score_res4", 1024, out, 1, res[2], res[2], False
    # depthwise: one input channel a group, `out` groups
    yield "score4_upsample", 1, out, 4, (2 * res[2][0], 2 * res[2][1]), res[2], True


def _conv_flops(cin: int, cout: int, k: int, out_hw, in_hw, transposed: bool) -> float:
    spatial = in_hw if transposed else out_hw
    return 2.0 * cout * cin * k * k * spatial[0] * spatial[1]


def forward_flops(hw: Sequence[int], stages: Sequence[int] = STAGES_R101, templates: int = 25) -> float:
    """FLOPs of one eval forward of one (H, W) image."""
    return sum(_conv_flops(*c[1:]) for c in convs(hw, stages, templates))


def train_flops(hw: Sequence[int], stages: Sequence[int] = STAGES_R101, templates: int = 25) -> float:
    """FLOPs of one image's forward and backward in a train step."""
    total = 0.0
    for name, *shape in convs(hw, stages, templates):
        f = _conv_flops(*shape)
        total += f  # forward
        if name != "conv1":
            total += f  # gradient of the input
        if name != "score4_upsample":
            total += f  # gradient of the weight
    return total


def level_canvases(h0p: int, w0p: int, scales: Sequence[int]) -> list:
    """The canvas of each pyramid level 2**s of an (h0p, w0p) canvas: each
    side rounded to a multiple of 32."""
    def up32(x: float) -> int:
        return (int(round(x)) + 31) // 32 * 32
    return [(up32(h0p * 2.0 ** s), up32(w0p * 2.0 ** s)) for s in scales]


def pyramid_flops(h0p: int, w0p: int, scales: Sequence[int], stages: Sequence[int] = STAGES_R101,
                  templates: int = 25) -> float:
    """FLOPs of one image's pyramid: a forward at every level's canvas."""
    return sum(forward_flops(hw, stages, templates) for hw in level_canvases(h0p, w0p, scales))

"""The frozen FLOP counts equal torch's FlopCounterMode over the reference
model on `meta`, and the kernel bounds equal hand counts."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.counts import bounds, flops
from perfbench.reference.model import Detector, param_shapes


def meta_detector(stages=(3, 4, 23), requires_grad=False):
    w = {k: torch.empty(s, device="meta", requires_grad=requires_grad and not k.startswith("score4_"))
         for k, s in param_shapes(stages).items()}
    return Detector(w, stages)


def counted(model, hw, train):
    x = torch.empty(1, 3, *hw, device="meta")
    with FlopCounterMode(display=False) as c:
        if train:
            model.forward(x, train=True).sum().backward()
        else:
            with torch.no_grad():
                model.forward(x)
    return float(c.get_total_flops())


@pytest.mark.parametrize("hw", [(192, 256), (384, 512), (768, 1024), (1536, 2048), (500, 500)])
def test_forward_count_equals_flop_counter(hw):
    assert flops.forward_flops(hw) == counted(meta_detector(), hw, False)


def test_train_count_equals_flop_counter():
    assert flops.train_flops((500, 500)) == counted(meta_detector(requires_grad=True), (500, 500), True)


def test_published_counts():
    assert flops.level_canvases(768, 1024, (-2, -1, 0, 1)) == [(192, 256), (384, 512), (768, 1024), (1536, 2048)]
    assert round(flops.pyramid_flops(768, 1024, (-2, -1, 0, 1)) / 1e12, 4) == 1.1767
    assert round(flops.train_flops((500, 500)) / 1e12, 4) == 0.2180


def test_n1_bound_hand_count():
    # 32 images, 4000 rows, 266 kept each: bytes 32*4000*18 / 3.35e12;
    # tests 32 * 266*265/2 * 14 / 33.5e12
    b = 32 * 4000 * 18 / 3.35e12
    o = 32 * (266 * 265 // 2) * 14 / 33.5e12
    assert math.isclose(bounds.n1_bound_s(4000, [266] * 32), max(b, o))
    assert math.isclose(bounds.n1_bound_s(4000, [3000]), 3000 * 2999 // 2 * 14 / 33.5e12)


def test_k1_bound_hand_count():
    anchors = 63 * 63 * 25
    ops = 15 * 346 * anchors / 67e12
    nbytes = 12 * 192 * 16 + 12 * 192 + 25 * 16 + 12 * 4 + 12 * anchors * 8 + 12 * 192 * 8
    assert math.isclose(bounds.k1_bound_s(346, 12, 192, anchors, 25), max(ops, nbytes / 3.35e12))
    assert math.isclose(bounds.k1_bound_s(0, 12, 192, anchors, 25), nbytes / 3.35e12)

"""FLOP count of ViTDet-B under the Tiny Faces head (reference/vitdet.py)
from its shapes alone.

Counting follows `torch.utils.flop_counter`'s convention, to which a test
ties it at a tiny size: 2 FLOPs a multiply-add of every linear layer,
convolution (a transposed one over its input's positions) and batched
matmul, the attention's too (scores q k^T and their product with v, in
each window or over every token, and the two relative-position einsums of
the bias); nothing for norms, GELU, softmax, the bias's sum, padding,
interpolation or adds. Windowed blocks run their linear layers and their
attention on the padded tokens, as published. A train step adds the
gradient of every input but the image's, and of every weight but the frozen
upsample's: twice the forward, except the patch embedding (its weight's
gradient alone) and the upsample (its input's alone).
"""

from __future__ import annotations

from typing import Iterator, Sequence


def _blocks(hw: Sequence[int], arch: dict) -> Iterator[tuple]:
    """(tokens the block's linear layers see, windows, tokens a window,
    rows of its relative-position lookups (kh, kw)) of each block."""
    gh, gw = hw[0] // arch["patch_size"], hw[1] // arch["patch_size"]
    for i in range(arch["depth"]):
        if i in arch["global_blocks"]:
            yield gh * gw, gh * gw, 1, gh * gw, (gh, gw)
        else:
            ws = arch["window_size"]
            nw = -(-gh // ws) * -(-gw // ws)
            yield gh * gw, nw * ws * ws, nw, ws * ws, (ws, ws)


def attention_forward(hw: Sequence[int], arch: dict) -> float:
    """One image's attention in one forward: q k^T, the product with v and
    the bias's two einsums, every block and head."""
    heads = arch["num_heads"]
    hd = arch["embed_dim"] // heads
    total = 0.0
    for _, _, nw, n, (kh, kw) in _blocks(hw, arch):
        total += heads * nw * (2 * 2.0 * n * n * hd + 2.0 * n * hd * (kh + kw))
    return total


def attention_train(hw: Sequence[int], arch: dict) -> float:
    """The same work in a train step: the forward and its gradients (q, k,
    v and the tables'), three times the forward."""
    return 3 * attention_forward(hw, arch)


def parts(hw: Sequence[int], arch: dict, templates: int = 25) -> Iterator[tuple]:
    """(name, forward FLOPs of one image, backward's multiple of them)."""
    h, w = hw
    p, d, c = arch["patch_size"], arch["embed_dim"], arch["pyramid_dim"]
    gh, gw = h // p, w // p
    yield "patch_embed", 2.0 * d * 3 * p * p * gh * gw, 1
    for i, (tokens, padded, *_) in enumerate(_blocks(hw, arch)):
        yield f"blocks.{i}.qkv+proj", 2.0 * padded * d * 4 * d, 2
        yield f"blocks.{i}.mlp", 2 * 2.0 * tokens * d * arch["mlp_dim"], 2
    yield "attention", attention_forward(hw, arch), 2
    g3 = 4 * gh * gw
    yield "simfp_3.0", 2.0 * d * (d // 2) * 4 * gh * gw, 2
    yield "simfp_3.1", 2.0 * (d // 2) * c * g3, 2
    yield "simfp_3.2", 2.0 * c * c * 9 * g3, 2
    yield "simfp_4.0", 2.0 * d * c * gh * gw, 2
    yield "simfp_4.1", 2.0 * c * c * 9 * gh * gw, 2
    out = 5 * templates
    yield "score_res3", 2.0 * c * out * g3, 2
    yield "score_res4", 2.0 * c * out * gh * gw, 2
    yield "score4_upsample", 2.0 * out * 16 * gh * gw, 1


def forward_flops(hw: Sequence[int], arch: dict, templates: int = 25) -> float:
    return sum(f for _, f, _ in parts(hw, arch, templates))


def train_flops(hw: Sequence[int], arch: dict, templates: int = 25) -> float:
    """FLOPs of one image's forward and backward in a train step."""
    return sum(f * (1 + k) for _, f, k in parts(hw, arch, templates))

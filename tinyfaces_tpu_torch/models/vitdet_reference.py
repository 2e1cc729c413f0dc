"""ViTDet-B under the Tiny Faces head as plain float32 functions over a dict
of named tensors: the reference the port's `models/vitdet.py` is held to.
It imports nothing of the port; `perfbench/reference/vitdet.py` is a byte
copy of this file (a test holds the two equal).

The architecture is ViTDet's plain backbone (Li, Mao, Girshick and He,
arXiv:2203.16527; detectron2 `projects/ViTDet`, `modeling/backbone/vit.py`
and `SimpleFeaturePyramid`), ViT-B in `mask_rcnn_vitdet_b_100ep.py`:

* patch embedding: a 16x16/16 convolution with a bias, 3 -> 768;
* absolute position embedding (1, 1 + 14*14, 768) from the pre-training
  grid: the class token's row dropped, the 14x14 grid interpolated
  bicubically (align_corners False) to the token grid;
* 12 pre-norm blocks, LayerNorm eps 1e-6: x = x + proj(attn(LN(x))), then
  x = x + fc2(GELU(fc1(LN(x)))), MLP 3072, exact (erf) GELU;
* attention of 12 heads of 64 with `qkv` biases: scores = (q * 64**-0.5)
  k^T + rel_h + rel_w, softmax over the keys, times v; the decomposed
  relative-position bias rel_h = einsum("bhwc,hkc->bhwk", q, R_h) (the
  unscaled q) and likewise rel_w, R_h and R_w taken from tables of 2S - 1
  rows (`get_rel_pos`, the tables interpolated linearly where their length
  differs);
* windowed attention (window 14) in blocks 0, 1, 3, 4, 6, 7, 9, 10: the
  normalised tokens zero-padded at the bottom and right to a multiple of
  14 (64 -> 70), partitioned into windows, attended within each window,
  unpartitioned and cropped. As published, the padded tokens take part as
  keys with no mask. Global attention over every token in blocks 2, 5, 8
  and 11;
* the simple feature pyramid's stride-8 and stride-16 outputs: p4 =
  LN2d(conv3x3(LN2d(conv1x1(x)))) to 256 channels without conv biases,
  p3 the same after a 2x2/2 transposed conv 768 -> 384 (with a bias);
  LN2d is a LayerNorm over the channels of each position, eps 1e-6.

The Tiny Faces head (arXiv:1612.04402) sits on p3 and p4 where the
ResNet's sits on res3 and res4: `score_res3` and `score_res4` 1x1 convs
256 -> 5T with biases, `score_res4` upsampled 2x by a frozen depthwise
4x4/2 transposed conv with the bilinear filter, cropped to p3's grid and
added.

Departures from detectron2: no class-token handling beyond dropping its
position row (ViTDet uses none); drop-path is 0 (published 0.1, a
regulariser with no work of its own); the pyramid's stride-4 and
stride-32 levels are left out (the head reads two levels); attention is
computed explicitly, softmax(q k^T * scale + bias) v, with no fused
kernel. `quant`, if given, rounds every tensor a low-precision run of the
detector stores (the input, each weight, each linear's, convolution's,
norm's and sum's output, the attention's scores and probabilities);
`rel_pos=False` leaves the relative-position bias out. Both exist for the
controls that the comparison's limits must fail.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

VITDET_B = {
    "img_size": 1024, "patch_size": 16, "embed_dim": 768, "depth": 12, "num_heads": 12,
    "mlp_dim": 3072, "window_size": 14, "global_blocks": [2, 5, 8, 11], "pretrain_grid": 14,
    "pyramid_dim": 256, "ln_eps": 1e-6,
}
NET = "model.net."


def rel_size(arch: dict, index: int) -> int:
    """S of block `index`'s relative-position tables (2S - 1 rows): the
    window in a windowed block, the token grid in a global one."""
    if index in arch["global_blocks"]:
        return arch["img_size"] // arch["patch_size"]
    return arch["window_size"]


def param_shapes(arch: dict = VITDET_B, templates: int = 25) -> dict:
    """name -> shape of every parameter (the port's state-dict names)."""
    d, hd = arch["embed_dim"], arch["embed_dim"] // arch["num_heads"]
    p, g, c = arch["patch_size"], arch["pretrain_grid"], arch["pyramid_dim"]
    s = {NET + "patch_embed.proj.weight": (d, 3, p, p), NET + "patch_embed.proj.bias": (d,),
         NET + "pos_embed": (1, 1 + g * g, d)}
    for i in range(arch["depth"]):
        b = f"{NET}blocks.{i}."
        r = 2 * rel_size(arch, i) - 1
        s.update({b + "norm1.weight": (d,), b + "norm1.bias": (d,),
                  b + "attn.qkv.weight": (3 * d, d), b + "attn.qkv.bias": (3 * d,),
                  b + "attn.proj.weight": (d, d), b + "attn.proj.bias": (d,),
                  b + "attn.rel_pos_h": (r, hd), b + "attn.rel_pos_w": (r, hd),
                  b + "norm2.weight": (d,), b + "norm2.bias": (d,),
                  b + "mlp.fc1.weight": (arch["mlp_dim"], d), b + "mlp.fc1.bias": (arch["mlp_dim"],),
                  b + "mlp.fc2.weight": (d, arch["mlp_dim"]), b + "mlp.fc2.bias": (d,)})
    s.update({"model.simfp_3.0.weight": (d, d // 2, 2, 2), "model.simfp_3.0.bias": (d // 2,),
              "model.simfp_3.1.weight": (c, d // 2, 1, 1), "model.simfp_3.2.weight": (c, c, 3, 3),
              "model.simfp_4.0.weight": (c, d, 1, 1), "model.simfp_4.1.weight": (c, c, 3, 3)})
    for n in ("simfp_3.1", "simfp_3.2", "simfp_4.0", "simfp_4.1"):
        s[f"model.{n}.norm.weight"] = s[f"model.{n}.norm.bias"] = (c,)
    out = 5 * templates
    s.update({"score_res3.weight": (out, c, 1, 1), "score_res3.bias": (out,),
              "score_res4.weight": (out, c, 1, 1), "score_res4.bias": (out,),
              "score4_upsample.weight": (out, 1, 4, 4)})
    return s


def torch_seed(seed: int, *key: int) -> int:
    """A 63-bit torch seed from the run's seed and a key."""
    return int(np.random.SeedSequence([seed % 2**63, *key]).generate_state(1, np.uint64)[0] >> 1)


def bilinear_filter(channels: int, device=None) -> torch.Tensor:
    """(C, 1, 4, 4): exact 2x bilinear upsampling by a 4x4/2 transposed conv."""
    v = torch.tensor([0.25, 0.75, 0.75, 0.25], device=device)
    return torch.outer(v, v).expand(channels, 1, 4, 4).contiguous()


def _trunc_normal(n: int, gen: torch.Generator, device) -> torch.Tensor:
    """n draws of the standard normal truncated to [-2, 2], by its inverse
    CDF."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(n, generator=gen, device=device) * (1.0 - 2.0 * lo) + lo
    return math.sqrt(2.0) * torch.special.erfinv(2.0 * u - 1.0)


def make_weights(seed: int, device, arch: dict = VITDET_B, templates: int = 25) -> dict:
    """Seeded weights, made on the device from one generator: linear
    weights, the position embedding and the relative-position tables
    trunc-normal with std 0.02 (ViTDet's linear and position init; its
    relative-position tables start at zero, a trained model's do not, and
    at zero the bias would be invisible to a check); convolutions
    LeCun-normal (std fan_in**-0.5, a transposed conv's fan-in its input
    channels); zero biases, unit LayerNorm scales, zero shifts; the
    upsample's bilinear filter."""
    shapes = param_shapes(arch, templates)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 0x5A17))
    trunc = [n for n, s in shapes.items() if n.endswith(("pos_embed", "rel_pos_h", "rel_pos_w"))
             or (len(s) == 2 and n.endswith(".weight"))]
    convs = [n for n, s in shapes.items() if len(s) == 4 and n != "score4_upsample.weight"]
    out = {}
    for names, draw in ((trunc, lambda k: _trunc_normal(k, gen, device) * 0.02),
                        (convs, lambda k: torch.randn(k, generator=gen, device=device))):
        sizes = [math.prod(shapes[n]) for n in names]
        for n, part in zip(names, torch.split(draw(sum(sizes)), sizes)):
            out[n] = part.view(shapes[n]).contiguous()
    for n in convs:
        s = shapes[n]
        fan_in = s[0] if n == "model.simfp_3.0.weight" else math.prod(s[1:])
        out[n] = out[n] * fan_in ** -0.5
    for n, s in shapes.items():
        if n in out:
            continue
        if n == "score4_upsample.weight":
            out[n] = bilinear_filter(s[0], device)
        elif n.endswith("norm1.weight") or n.endswith("norm2.weight") or n.endswith("norm.weight"):
            out[n] = torch.ones(s, device=device)
        else:
            out[n] = torch.zeros(s, device=device)
    return out


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C): the table row of each query-key offset, the
    table interpolated linearly to 2 max(q, k) - 1 rows where it has
    another length (detectron2's `get_rel_pos`)."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=max_rel_dist, mode="linear")
        rel_pos = resized.reshape(-1, max_rel_dist).permute(1, 0)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long()]


class VitDet:
    """forward(x) for NCHW float32 x (H and W multiples of 16) -> (B, 5T,
    H/8, W/8) float32 logits and regressions."""

    def __init__(self, weights: dict, arch: dict = VITDET_B, quant: Optional[Callable] = None,
                 rel_pos: bool = True):
        self.w, self.arch, self.quant, self.rel_pos = weights, arch, quant, rel_pos

    def q(self, x):
        return x if self.quant is None else self.quant(x)

    def p(self, name):
        return self.q(self.w[name])

    def linear(self, x, name):
        return self.q(F.linear(x, self.p(name + ".weight"), self.p(name + ".bias")))

    def layer_norm(self, x, name):
        return self.q(F.layer_norm(x, x.shape[-1:], self.p(name + ".weight"), self.p(name + ".bias"),
                                   self.arch["ln_eps"]))

    def layer_norm2d(self, x, name):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        y = (x - u) / torch.sqrt(s + self.arch["ln_eps"])
        return self.q(self.p(name + ".weight")[:, None, None] * y + self.p(name + ".bias")[:, None, None])

    def attention(self, x, prefix):
        """x (B, H, W, C) -> (B, H, W, C)."""
        b, h, w, c = x.shape
        heads = self.arch["num_heads"]
        hd = c // heads
        qkv = self.linear(x, prefix + "qkv").reshape(b, h * w, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * heads, h * w, hd).unbind(0)
        attn = self.q((q * hd ** -0.5) @ k.transpose(-2, -1))
        if self.rel_pos:
            rh = get_rel_pos(h, h, self.p(prefix + "rel_pos_h"))
            rw = get_rel_pos(w, w, self.p(prefix + "rel_pos_w"))
            r_q = q.reshape(b * heads, h, w, hd)
            rel_h = self.q(torch.einsum("bhwc,hkc->bhwk", r_q, rh))
            rel_w = self.q(torch.einsum("bhwc,wkc->bhwk", r_q, rw))
            attn = self.q((attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
                           + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w))
        attn = self.q(attn.softmax(dim=-1))
        out = self.q(attn @ v).view(b, heads, h, w, hd).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return self.linear(out, prefix + "proj")

    def block(self, x, i):
        pre = f"{NET}blocks.{i}."
        ws = 0 if i in self.arch["global_blocks"] else self.arch["window_size"]
        shortcut = x
        x = self.layer_norm(x, pre + "norm1")
        if ws:
            b, h, w, c = x.shape
            ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
            x = F.pad(x, (0, 0, 0, pw, 0, ph))
            hp, wp = h + ph, w + pw
            x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
        x = self.attention(x, pre + "attn.")
        if ws:
            x = x.view(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
            x = x[:, :h, :w, :]
        x = self.q(shortcut + x)
        y = self.linear(self.layer_norm(x, pre + "norm2"), pre + "mlp.fc1")
        y = self.linear(self.q(F.gelu(y)), pre + "mlp.fc2")
        return self.q(x + y)

    def backbone(self, x):
        """NCHW image -> (p3, p4), NCHW, strides 8 and 16."""
        a = self.arch
        x = F.conv2d(self.q(x), self.p(NET + "patch_embed.proj.weight"), self.p(NET + "patch_embed.proj.bias"),
                     stride=a["patch_size"])
        x = self.q(x).permute(0, 2, 3, 1)
        h, w = x.shape[1], x.shape[2]
        g = a["pretrain_grid"]
        pos = self.p(NET + "pos_embed")[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        if (g, g) != (h, w):
            pos = F.interpolate(pos, size=(h, w), mode="bicubic", align_corners=False)
        x = self.q(x + self.q(pos.permute(0, 2, 3, 1)))
        for i in range(a["depth"]):
            x = self.block(x, i)
        x = x.permute(0, 3, 1, 2)
        p3 = self.q(F.conv_transpose2d(x, self.p("model.simfp_3.0.weight"), self.p("model.simfp_3.0.bias"),
                                       stride=2))
        for n, pad in (("model.simfp_3.1", 0), ("model.simfp_3.2", 1)):
            p3 = self.layer_norm2d(self.q(F.conv2d(p3, self.p(n + ".weight"), None, padding=pad)), n + ".norm")
        p4 = x
        for n, pad in (("model.simfp_4.0", 0), ("model.simfp_4.1", 1)):
            p4 = self.layer_norm2d(self.q(F.conv2d(p4, self.p(n + ".weight"), None, padding=pad)), n + ".norm")
        return p3, p4

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p3, p4 = self.backbone(x)
        s3 = self.q(F.conv2d(p3, self.p("score_res3.weight"), self.p("score_res3.bias")))
        s4 = self.q(F.conv2d(p4, self.p("score_res4.weight"), self.p("score_res4.bias")))
        s4 = self.q(F.conv_transpose2d(s4, self.p("score4_upsample.weight"), stride=2, padding=1,
                                       groups=s4.shape[1]))
        return self.q(s3 + s4[:, :, : s3.shape[2], : s3.shape[3]])


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale that maps its
    largest magnitude to 448, and back: a tensor stored in fp8."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

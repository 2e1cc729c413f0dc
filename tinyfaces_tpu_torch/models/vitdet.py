"""ViTDet-B backbone with the simple feature pyramid, as torch.nn modules:
the Tiny Faces head reads its stride-8 and stride-16 outputs where it reads
a ResNet's res3 and res4 (models/detection.py, architecture `vitdet_b`).

ViTDet (Li, Mao, Girshick and He, arXiv:2203.16527; detectron2
`projects/ViTDet`, `mask_rcnn_vitdet_b_100ep.py`), computed as detectron2's
`ViT` and `SimpleFeaturePyramid` compute it:

* `net.patch_embed`: a 16x16/16 convolution 3 -> 768 with a bias; then the
  absolute position embedding of the 14x14 pre-training grid (its class
  token's row dropped), interpolated bicubically (align_corners False) to
  the token grid, 64x64 at the published 1024x1024 input;
* `net.blocks`: 12 pre-norm blocks (LayerNorm eps 1e-6, MLP 3072, exact
  GELU). Attention has 12 heads of 64 with `qkv` biases and the decomposed
  relative-position bias in every block: scores = (q * 64**-0.5) k^T +
  rel_h + rel_w, rel_h = einsum("bhwc,hkc->bhwk", q, R_h) with the
  unscaled q, R_h and R_w from tables of 2S - 1 rows (`get_rel_pos`,
  interpolated linearly where the length differs). Blocks 0, 1, 3, 4, 6,
  7, 9, 10 attend within 14x14 windows: the normalised tokens are
  zero-padded at the bottom and right to a multiple of 14 (64 -> 70, so
  4,900 tokens for 4,096) and, as published, the padded tokens take part
  as keys with no mask. Blocks 2, 5, 8, 11 attend over every token;
* `simfp_3` (stride 8): a 2x2/2 transposed conv 768 -> 384, then a 1x1
  and a 3x3 conv to 256 without biases, each followed by a LayerNorm over
  the channels (`LayerNorm2d`); `simfp_4` (stride 16): the same two convs
  from 768. Names follow detectron2's, under `net.` for the ViT.

Drop-path is not built (0 here; 0.1 published, a regulariser with no work
of its own whose draws would have to be made outside a captured graph).

`dtype` is the port's mixed-precision knob, as in models/resnet.py: the
parameters stay float32 and are cast per op to the activation dtype; each
LayerNorm normalises in float32 and rounds its output to the activation
dtype. Attention runs through `F.scaled_dot_product_attention` with the
relative-position bias as its additive mask: the two bias terms are
computed in float32 from q and the tables and stored in the activation
dtype (the fused kernel's bias operand takes the query's dtype), and the
kernel adds them to its float32 scores and keeps its softmax statistics in
float32. On a card the attention is restricted to the memory-efficient
backend, the fused one that takes an additive bias and returns its
gradient; where it cannot run, SDPA raises instead of falling back to the
math backend.

Spans (utils/profiling.py): `vit.embed`, `vit.block` (attributes `index`
and `kind`, "window" or "global") and `vit.pyramid`. Each attention call
counts one launch `sdpa.<kind>.<backend>` through `graphs.count_launch`,
so a replayed graph counts its calls as it counts K1's; `tokens` holds the
last forward's `attn_tokens` (tokens that entered attention, padding
included, over every block and image) and `attn_pad_tokens` (of those, the
windows' padding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tinyfaces_tpu_torch.models.resnet import Conv2d
from tinyfaces_tpu_torch.utils import graphs
from tinyfaces_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class VitConfig:
    """ViTDet-B's published settings (the defaults)."""

    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    window_size: int = 14
    global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    pretrain_grid: int = 14  # the 224x224 pre-training input's token grid
    pyramid_dim: int = 256
    ln_eps: float = 1e-6

    def rel_size(self, index: int) -> int:
        """S of block `index`'s relative-position tables (2S - 1 rows)."""
        return self.img_size // self.patch_size if index in self.global_blocks else self.window_size


VITDET_B = VitConfig()

_BACKENDS = {1: "flash", 2: "efficient", 3: "cudnn"}  # torch's SDPBackend values
_chosen: dict = {}  # (shapes, dtype, device) -> the backend SDPA took


def _float(x: torch.Tensor) -> torch.Tensor:
    """x in at least float32 (a float64 model stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class Linear(nn.Linear):
    """nn.Linear whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim in float32, rounded to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(_float(x), self.normalized_shape, self.weight, self.bias, self.eps).to(x.dtype)


class LayerNorm2d(nn.Module):
    """detectron2's channel LayerNorm of an NCHW map, in float32, rounded to
    the input's dtype."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(_float(x).permute(0, 2, 3, 1), x.shape[1:2], self.weight, self.bias, self.eps)
        return y.permute(0, 3, 1, 2).to(x.dtype)


class NormedConv2d(Conv2d):
    """A convolution followed by its norm (detectron2's Conv2d with `norm`)."""

    def __init__(self, cin: int, cout: int, k: int, eps: float):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.norm = LayerNorm2d(cout, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(super().forward(x))


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d whose float32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C): the table row of each query-key offset; a table
    of another length than 2 max(q, k) - 1 is interpolated linearly to it
    (detectron2's `get_rel_pos`)."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=max_rel_dist, mode="linear")
        rel_pos = resized.reshape(-1, max_rel_dist).permute(1, 0)
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.long()]


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor, scale: float,
         kind: str) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v, on a card through SDPA's
    memory-efficient backend alone (it raises where that cannot run);
    counted as one launch `sdpa.<kind>.<backend>`."""
    if q.device.type != "cuda":
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)
        graphs.count_launch(f"sdpa.{kind}.cpu")
        return out
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
        key = (q.shape, bias.shape, q.dtype, q.device)
        if key not in _chosen:
            choice = torch._fused_sdp_choice(q, k, v, bias, 0.0, False, scale=scale)
            if choice not in _BACKENDS:
                raise RuntimeError(f"no fused SDPA backend takes the {kind} attention's bias "
                                   f"with its gradient (torch chose {choice})")
            _chosen[key] = _BACKENDS[choice]
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias, scale=scale)
    graphs.count_launch(f"sdpa.{kind}.{_chosen[key]}")
    return out


class Attention(nn.Module):
    """Multi-head attention with the decomposed relative-position bias, on
    (B, H, W, C) tokens; `kind` names it in the launch counts."""

    def __init__(self, dim: int, heads: int, rel_size: int, kind: str):
        super().__init__()
        self.heads, self.kind = heads, kind
        hd = dim // heads
        self.scale = hd ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * rel_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * rel_size - 1, hd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        hd = c // self.heads
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
        r_q = _float(q).reshape(b, self.heads, h, w, hd)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, get_rel_pos(h, h, self.rel_pos_h).to(r_q.dtype))
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, get_rel_pos(w, w, self.rel_pos_w).to(r_q.dtype))
        bias = (rel_h.to(x.dtype)[..., :, None] + rel_w.to(x.dtype)[..., None, :]).reshape(
            b, self.heads, h * w, h * w)
        out = sdpa(q, k, v, bias, self.scale, self.kind)
        return self.proj(out.permute(0, 2, 1, 3).reshape(b, h, w, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


def window_partition(x: torch.Tensor, ws: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, C) -> (B * nW, ws, ws, C) windows of x zero-padded at the
    bottom and right to multiples of ws, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int, pad_hw: tuple[int, int],
                       hw: tuple[int, int]) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.view(b, hp // ws, wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :w, :]


class Block(nn.Module):
    def __init__(self, cfg: VitConfig, index: int):
        super().__init__()
        self.window = 0 if index in cfg.global_blocks else cfg.window_size
        self.kind = "window" if self.window else "global"
        self.norm1 = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.attn = Attention(cfg.embed_dim, cfg.num_heads, cfg.rel_size(index), self.kind)
        self.norm2 = LayerNorm(cfg.embed_dim, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg.embed_dim, cfg.mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window:
            hw = (x.shape[1], x.shape[2])
            x, pad_hw = window_partition(x, self.window)
            x = window_unpartition(self.attn(x), self.window, pad_hw, hw)
        else:
            x = self.attn(x)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv2d(3, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x).permute(0, 2, 3, 1)  # (B, H/p, W/p, C)


class ViT(nn.Module):
    """The plain ViT of ViTDet: tokens (B, H/16, W/16, C) out."""

    def __init__(self, cfg: VitConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.patch_size, cfg.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pretrain_grid ** 2, cfg.embed_dim))
        self.blocks = nn.ModuleList(Block(cfg, i) for i in range(cfg.depth))

    def abs_pos(self, h: int, w: int) -> torch.Tensor:
        g = self.cfg.pretrain_grid
        pos = self.pos_embed[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
        if (g, g) != (h, w):
            pos = F.interpolate(pos, size=(h, w), mode="bicubic", align_corners=False)
        return pos.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("vit.embed"):
            x = self.patch_embed(x)
            x = x + self.abs_pos(x.shape[1], x.shape[2]).to(x.dtype)
        for i, blk in enumerate(self.blocks):
            with span("vit.block", index=i, kind=blk.kind):
                x = blk(x)
        return x


class VitDetBackbone(nn.Module):
    """ViT + the simple feature pyramid's stride-8 and stride-16 levels, on
    NCHW input; returns (p3, p4), NCHW, 256 channels each."""

    def __init__(self, cfg: VitConfig = VITDET_B, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d, c, eps = cfg.embed_dim, cfg.pyramid_dim, cfg.ln_eps
        self.net = ViT(cfg)
        self.simfp_3 = nn.Sequential(ConvTranspose2d(d, d // 2, 2, stride=2),
                                     NormedConv2d(d // 2, c, 1, eps), NormedConv2d(c, c, 3, eps))
        self.simfp_4 = nn.Sequential(NormedConv2d(d, c, 1, eps), NormedConv2d(c, c, 3, eps))
        self.tokens = {"attn_tokens": 0, "attn_pad_tokens": 0}

    def token_counts(self, batch: int, h: int, w: int) -> dict:
        """Tokens entering attention in one forward of (batch, 3, h, w)
        (padding included) over every block, and of those the windows'
        padding."""
        gh, gw = h // self.cfg.patch_size, w // self.cfg.patch_size
        tokens = pad = 0
        for blk in self.net.blocks:
            n = gh * gw
            if blk.window:
                ws = blk.window
                n = -(-gh // ws) * ws * (-(-gw // ws) * ws)
                pad += batch * (n - gh * gw)
            tokens += batch * n
        return {"attn_tokens": tokens, "attn_pad_tokens": pad}

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self.dtype is not None:
            x = x.to(self.dtype)
        self.tokens = self.token_counts(x.shape[0], x.shape[2], x.shape[3])
        x = self.net(x).permute(0, 3, 1, 2)
        with span("vit.pyramid"):
            return self.simfp_3(x), self.simfp_4(x)

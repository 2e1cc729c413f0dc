"""Fixed-K box decoding of dense score maps, batched over images.

Port of tinyfaces_tpu/ops/decode.py. Per image and pyramid level: sigmoid
of the template logits, padding rows/columns and pruned templates zeroed,
the K most probable (position, template) cells kept, anchors recovered from
the receptive-field grid and refined as

    cx' = cx + w*tx,   w' = w*exp(tw)   (and likewise for y/h),

then divided by the level's scale. Cells at or under `prob_thresh` come out
invalid: score -inf, box 0.

Tie order: `lax.top_k` puts the lowest flat index first among equal values,
and `torch.topk` promises no order. The K cells are chosen by a top-k over
a unique int64 key, (bits of the probability << 32) | (2^32 - 1 - index):
probabilities are non-negative, so their float bits order like the values,
and the index half makes the lowest index win a tie. The TPU-only two-stage
`exact_top_k` is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, K, 4) x1, y1, x2, y2 in original-image coords
    scores: torch.Tensor  # (B, K) classification logits (the reference keeps logits)
    valid: torch.Tensor  # (B, K) bool


def valid_template_mask(templates: np.ndarray, scale: float,
                        pruning: str = "reference") -> np.ndarray:
    """(T,) bool — which templates may fire at this pyramid scale.

    "reference" mirrors the reference's models/utils.py:15-44 exactly, dead
    branch included: the type-B ids (18..24, natural scale 2.0) are compared
    against 1.0 in every branch and so never fire; only ids 4..11 emit.
    "natural" applies the pruning those branches intend: type-B fires at
    pyramid scales > 1."""
    nt = templates.shape[0]
    all_scale_ids = np.arange(4, 12)
    one_scale_ids = np.arange(18, min(25, nt))
    tscales = templates[:, 4]

    if pruning == "natural":
        if scale > 1:
            bad = one_scale_ids[tscales[one_scale_ids] != 2.0]
        else:
            bad = one_scale_ids
    elif scale < 1:
        bad = one_scale_ids[tscales[one_scale_ids] >= 1.0]
    else:  # scale >= 1 — both reference branches test != 1.0
        bad = one_scale_ids[tscales[one_scale_ids] != 1.0]

    mask = np.zeros(nt, dtype=bool)
    mask[all_scale_ids] = True
    mask[one_scale_ids] = True
    mask[bad] = False
    return mask


def top_k_lowest_index(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis of a non-negative float32 tensor, in
    descending order with the lowest index first among equal values
    (`lax.top_k`'s order)."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    key = (bits << 32) | (0xFFFFFFFF - idx)
    top_key = torch.topk(key, k, dim=-1, sorted=True).values
    top_idx = 0xFFFFFFFF - (top_key & 0xFFFFFFFF)
    return torch.gather(x, -1, top_idx), top_idx


def decode_scores(
    output: torch.Tensor,  # (B, H, W, 5T) raw model output of one level
    templates: torch.Tensor,  # (T, >=4) float32
    template_valid: torch.Tensor | None = None,  # (T,) bool, used when valid_ids is None
    *,
    prob_thresh: float,
    stride: float,
    offset: float,
    scale: float,
    k: int,
    valid_hw: tuple[torch.Tensor, torch.Tensor] | None = None,
    valid_ids: Sequence[int] | torch.Tensor | None = None,
) -> Detections:
    """Top-K decode of a batch of score maps into refined boxes.

    `valid_hw`: (B,) integer tensors of the heatmap rows and columns that
    come from the image rather than its padding. `valid_ids`: the template
    ids that may fire at this scale; the top-K then runs over those
    channels only (pruned channels could never pass anyway)."""
    b, h, w, c = output.shape
    nt = templates.shape[0]
    dev = output.device

    if valid_ids is not None:
        ids = torch.as_tensor(valid_ids, dtype=torch.int64).to(dev, non_blocking=True)
        ntv = len(valid_ids)
        prob = torch.sigmoid(output.index_select(3, ids))
    else:
        ids = None
        ntv = nt
        prob = torch.sigmoid(output[..., :nt])
        prob = torch.where(template_valid.to(dev), prob, 0.0)
    if valid_hw is not None:
        hv, wv = valid_hw
        row_ok = torch.arange(h, device=dev)[None, :, None, None] < hv[:, None, None, None]
        col_ok = torch.arange(w, device=dev)[None, None, :, None] < wv[:, None, None, None]
        prob = torch.where(row_ok & col_ok, prob, 0.0)

    flat_prob = prob.reshape(b, -1)
    k_eff = min(k, flat_prob.shape[1])
    top_prob, top_idx = top_k_lowest_index(flat_prob, k_eff)
    if k_eff < k:  # tiny maps: keep the static K output shape
        top_prob = torch.nn.functional.pad(top_prob, (0, k - k_eff))
        top_idx = torch.nn.functional.pad(top_idx, (0, k - k_eff))
    valid = top_prob > prob_thresh

    fc = top_idx % ntv
    if ids is not None:
        fc = ids[fc]  # back to real template ids
    fx = (top_idx // ntv) % w
    fy = top_idx // (ntv * w)

    # Anchor geometry from the receptive field (reference utils.py:52-55).
    cy = fy.to(torch.float32) * stride + offset
    cx = fx.to(torch.float32) * stride + offset
    tmpl = templates.to(dev, torch.float32)
    cw = tmpl[fc, 2] - tmpl[fc, 0] + 1.0
    ch = tmpl[fc, 3] - tmpl[fc, 1] + 1.0

    # Channels [fc, T+fc, 2T+fc, 3T+fc, 4T+fc] at the winning positions:
    # the logit, then tx, ty, tw, th.
    # Gathered in channel-major order: the model's output is a permuted
    # view of an NCHW tensor, so this reshape is free.
    loc = fy * w + fx
    chan = fc[..., None] + nt * torch.arange(5, device=dev)
    flat = output.permute(0, 3, 1, 2).reshape(b, c * h * w)
    vals = flat.gather(1, (chan * (h * w) + loc[..., None]).reshape(b, -1)).reshape(b, k, 5)
    tx, ty, tw, th = vals[..., 1], vals[..., 2], vals[..., 3], vals[..., 4]

    # Refinement (reference utils.py:79-100).
    rcx = cx + cw * tx
    rcy = cy + ch * ty
    rcw = cw * torch.exp(tw)
    rch = ch * torch.exp(th)

    boxes = torch.stack([rcx - rcw / 2, rcy - rch / 2, rcx + rcw / 2, rcy + rch / 2], dim=-1)
    boxes = boxes / scale  # back to original-image coordinates (utils.py:72-74)

    boxes = torch.where(valid[..., None], boxes, 0.0)
    scores = torch.where(valid, vals[..., 0], -torch.inf)
    return Detections(boxes=boxes, scores=scores, valid=valid)

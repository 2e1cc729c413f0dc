"""On-device hard-negative mining and pos/neg balance sampling.

Port of tinyfaces_tpu/ops/sampling.py:
* hard_negative_mining (reference loss.py:59-63): recompute the elementwise
  soft-margin loss on detached logits and set the label to 0 (ignore) where
  it is below thresh — easy positives are dropped too, as in the reference;
* balance_sample (models/utils.py:103-139): keep a uniformly random exact-K
  subset of positives (K = sample_size * pos_fraction) and of negatives,
  whose cap is computed from the *constant* positive cap, not the surviving
  count (reference quirk at utils.py:126, kept).

Exact-K selection ranks i.i.d. uniforms: a candidate is kept iff its draw
is among the K smallest candidate draws. The uniforms are drawn from a
torch.Generator, or passed in (tests feed the JAX package's draws).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def soft_margin_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise log(1 + exp(-y*x)) == softplus(-y*x), numerically stable."""
    return F.softplus(-targets * logits)


def hard_negative_mining(logits: torch.Tensor, class_map: torch.Tensor,
                         loss_thresh: float = 0.03) -> torch.Tensor:
    """Zero (ignore) labels whose detached soft-margin loss is below thresh."""
    loss = soft_margin_loss(logits.detach(), class_map)
    return torch.where(loss < loss_thresh, 0.0, class_map)


def _keep_random_k(candidates: torch.Tensor, k: int, u: torch.Tensor) -> torch.Tensor:
    """(B, N) bool mask keeping, per row, the candidates whose uniform `u` is
    among the k smallest; all candidates when a row has fewer than k."""
    if k >= candidates.shape[1]:
        return candidates
    ranked = torch.where(candidates, u, torch.inf)
    # Only the k-th smallest value is used, so topk's tie order is irrelevant.
    kth_val = torch.topk(ranked, k, dim=1, largest=False).values.amax(dim=1, keepdim=True)
    return candidates & (ranked <= kth_val)


def draw_uniforms(generator: torch.Generator | None, rows: int, n: int,
                  device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (pos, neg) balance-sampling uniforms, each (rows, n), from
    `generator` (on its device, or `device` without one)."""
    gen_dev = generator.device if generator is not None else device
    return tuple(torch.rand((rows, n), generator=generator, device=gen_dev) for _ in range(2))


def balance_sample_batch(
    class_map: torch.Tensor,  # (B, ...) labels in {-1, 0, +1}
    generator: torch.Generator | None = None,
    sample_size: int = 256,
    pos_fraction: float = 0.5,
    uniforms: tuple[torch.Tensor, torch.Tensor] | None = None,  # (pos, neg), each (B, N)
    part: tuple[int, int] = (0, 1),
) -> torch.Tensor:
    """Randomly zero out excess positives/negatives of each sample. `part` =
    (rank, world): the batch is rank's rows of a global batch of world * B;
    the uniforms are drawn for the global batch and rank's rows kept, as
    world 1 draws them."""
    pos_max = int(sample_size * pos_fraction)
    neg_max = int(pos_max * (1 - pos_fraction) / pos_fraction)

    flat = class_map.reshape(class_map.shape[0], -1)
    if uniforms is None:
        (r, w), b = part, flat.shape[0]
        uniforms = tuple(u[r * b:(r + 1) * b]
                         for u in draw_uniforms(generator, w * b, flat.shape[1], flat.device))
    pos_u, neg_u = (u.to(flat.device, flat.dtype) for u in uniforms)

    pos = flat == 1.0
    neg = flat == -1.0
    out = torch.where(pos & ~_keep_random_k(pos, pos_max, pos_u), 0.0, flat)
    out = torch.where(neg & ~_keep_random_k(neg, neg_max, neg_u), 0.0, out)
    return out.reshape(class_map.shape)


def balance_sample(class_map: torch.Tensor, generator: torch.Generator | None = None,
                   sample_size: int = 256, pos_fraction: float = 0.5,
                   uniforms: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """One sample's balance sampling; `uniforms` are (N,) each."""
    if uniforms is not None:
        uniforms = tuple(u[None] for u in uniforms)
    return balance_sample_batch(class_map[None], generator, sample_size, pos_fraction,
                                uniforms)[0]

"""Device-side batch preparation: normalization + GT target heatmaps.

Port of tinyfaces_tpu/data/targets.py on the `rgb` wire. The batch's tensors
already sit on the training device; the assignment reductions run there
(the CUDA kernel on a GPU, the plain twin on the CPU).
"""

from __future__ import annotations

import torch

from tinyfaces_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, DetectorConfig
from tinyfaces_tpu_torch.ops.assignment import compute_pad_mask
from tinyfaces_tpu_torch.ops.assignment_kernel import assign_targets_fused


def normalize_images(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalized float (ToTensor + ImageNet Normalize,
    reference main.py:44-46)."""
    # Uploaded without a stream sync, so a caller can queue batches ahead.
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype).to(images_u8.device, non_blocking=True)
    std = torch.tensor(IMAGENET_STD, dtype=dtype).to(images_u8.device, non_blocking=True)
    x = images_u8.to(dtype) / 255.0
    return (x - mean) / std


def build_targets(
    batch: dict,
    templates: torch.Tensor,
    generator: torch.Generator | None,
    cfg: DetectorConfig,
    noise_tensor: torch.Tensor | None = None,
):
    """Returns (images (B,H,W,3), class_maps (B,Y,X,T), regress_maps
    (B,Y,X,4T)). `noise_tensor` replaces the tie-break draws (CPU only)."""
    vsy, vsx = cfg.heatmap_size
    ofy, ofx = cfg.rf.offset
    sty, stx = cfg.rf.stride
    rf = dict(ofx=float(ofx), ofy=float(ofy), stx=float(stx), sty=float(sty))

    images = normalize_images(batch["image"])
    templates = templates.to(images.device, torch.float32)
    pad_masks = compute_pad_mask(batch["paste_box"], templates, vsx=vsx, vsy=vsy,
                                 flip=batch["flip"], **rf)
    cls_maps, reg_maps = assign_targets_fused(
        batch["gt_boxes"], batch["gt_valid"], pad_masks, templates, generator,
        pos_thresh=cfg.pos_thresh, neg_thresh=cfg.neg_thresh,
        noise_tensor=noise_tensor, **rf,
    )
    return images, cls_maps, reg_maps

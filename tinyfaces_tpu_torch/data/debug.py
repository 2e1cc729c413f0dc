"""Debug rendering of ground-truth heatmaps and live model output.

Port of tinyfaces_tpu/data/debug.py (reference DataProcessor.
visualize_heatmaps, processor.py:279-338, and trainer.visualize_output,
trainer.py:29-64): decode a class/regression map pair back into boxes
(anchor geometry and regression refinement), NMS them, and draw them onto
the image. NumPy on the host; the NMS is the port's (ops/nms.py) on the
CPU. PIL is imported only to draw.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tinyfaces_tpu_torch.config import IMAGENET_MEAN, IMAGENET_STD, DetectorConfig
from tinyfaces_tpu_torch.ops.nms import nms
from tinyfaces_tpu_torch.utils.visualize import draw_bounding_box


def heatmap_to_boxes(
    cls_map: np.ndarray,  # (Y, X, T) labels or probabilities
    reg_map: np.ndarray,  # (Y, X, 4T)
    templates: np.ndarray,
    cfg: Optional[DetectorConfig] = None,
    prob_thresh: float = 1.0,
    nms_thresh: float = 1.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(boxes (N, 4), scores (N,)) float32 of the map locations with cls >=
    prob_thresh, refined by the regression and, when nms_thresh < 1, NMSed.

    The template width and height are x2 - x1 and y2 - y1, without the +1
    of the eval decode: the reference's visualize_heatmaps (processor.py:
    287-318) takes them so, and the debug rendering keeps its quirk."""
    cfg = cfg or DetectorConfig()
    sty, stx = cfg.rf.stride
    ofy, ofx = cfg.rf.offset
    nt = templates.shape[0]

    fy, fx, fc = np.where(cls_map >= prob_thresh)
    cy, cx = fy * sty + ofy, fx * stx + ofx
    cw = templates[fc, 2] - templates[fc, 0]
    ch = templates[fc, 3] - templates[fc, 1]
    tx, ty, tw, th = (reg_map[:, :, k * nt:(k + 1) * nt][fy, fx, fc] for k in range(4))

    rx = cx + cw * tx
    ry = cy + ch * ty
    rw = cw * np.exp(tw)
    rh = ch * np.exp(th)
    boxes = np.stack([np.abs(rx - rw / 2), np.abs(ry - rh / 2), rx + rw / 2, ry + rh / 2],
                     axis=1).astype(np.float32)
    scores = cls_map[fy, fx, fc].astype(np.float32)

    if boxes.shape[0] and nms_thresh < 1.0:
        order, keep = nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], nms_thresh)
        idx = order[0][keep[0]].numpy()
        boxes, scores = boxes[idx], scores[idx]
    return boxes, scores


def visualize_heatmaps(
    img,  # PIL image
    cls_map: np.ndarray,
    reg_map: np.ndarray,
    templates: np.ndarray,
    cfg: Optional[DetectorConfig] = None,
    prob_thresh: float = 1.0,
    nms_thresh: float = 1.0,
    show: bool = True,
):
    """Draw heatmap_to_boxes' boxes, numbered, onto `img`; show it when asked."""
    boxes, _ = heatmap_to_boxes(cls_map, reg_map, templates, cfg, prob_thresh, nms_thresh)
    print("Number of bboxes ", boxes.shape[0])
    for idx, bbox in enumerate(boxes):
        img = draw_bounding_box(img, np.round(bbox), {"name": str(idx)})
    if show:
        img.show(title="Heatmap visualized")
    return img


def denormalize_image(x: np.ndarray) -> np.ndarray:
    """Normalized float image (H, W, 3) -> uint8 (trainer.py:36-40)."""
    mean = np.asarray(IMAGENET_MEAN)
    std = np.asarray(IMAGENET_STD)
    return np.clip((x * std + mean) * 255.0, 0, 255).astype(np.uint8)


def visualize_output(
    image: np.ndarray,  # (H, W, 3) normalized float image
    output: np.ndarray,  # (Y, X, 5T) model output (NHWC)
    templates: np.ndarray,
    cfg: Optional[DetectorConfig] = None,
    prob_thresh: float = 0.55,
    nms_thresh: float = 0.1,
    show: bool = True,
):
    """Render a live training-time prediction (trainer.py:29-58): sigmoid the
    class channels and reuse the heatmap decode."""
    from PIL import Image

    nt = templates.shape[0]
    prob = 1.0 / (1.0 + np.exp(-output[..., :nt]))
    return visualize_heatmaps(Image.fromarray(denormalize_image(image)), prob, output[..., nt:],
                              templates, cfg, prob_thresh, nms_thresh, show=show)

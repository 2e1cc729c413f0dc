"""PIL bounding-box drawing for `main.py --debug` (port of
tinyfaces_tpu/utils/visualize.py; reference tinyfaces/utils/visualize.py:
5-68). Pillow is imported inside the functions."""

from __future__ import annotations

from typing import Optional

import numpy as np


def draw_bounding_box(image, bbox, label: Optional[dict] = None, width: int = 2,
                      color: str = "red"):
    """Draw one box (x1, y1, x2, y2) onto a PIL image, optionally labeled."""
    from PIL import ImageDraw

    draw = ImageDraw.Draw(image)
    x1, y1, x2, y2 = [float(v) for v in bbox[:4]]
    draw.rectangle(((x1, y1), (x2, y2)), outline=color, width=width)
    if label and "name" in label:
        draw.text((x1, max(0.0, y1 - 10)), str(label["name"]), fill=color)
    return image


def visualize_bboxes(image, bboxes, show: bool = True):
    """Render all boxes; show interactively when requested."""
    for i, bbox in enumerate(np.asarray(bboxes)):
        image = draw_bounding_box(image, bbox, {"name": str(i)})
    if show:
        image.show()
    return image

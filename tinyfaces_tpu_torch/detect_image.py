"""Single-image detection CLI of the port — the surface of detect_image.py
(reference detect_image.py:17-26):

    python -m tinyfaces_tpu_torch.detect_image IMAGE [--checkpoint CKPT]
        [--output annotated.png] [--device cuda]

Loads the templates and the checkpoint, detects at a single scale
(scales=(0,)), draws the boxes, and saves the image to `--output` or shows
it. Only the `rgb` wire is ported (`--transfer` other than rgb exits,
naming ROADMAP item 10 or 15). `--device` (default cuda) is the port's own
flag.
"""

from __future__ import annotations

import argparse

import numpy as np

from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.evaluation import PyramidDetector, get_model


def arguments(argv=None):
    parser = argparse.ArgumentParser("Image Evaluator")
    parser.add_argument("image_path")
    parser.add_argument("--checkpoint", help="The path to the model checkpoint", default="")
    parser.add_argument("--prob_thresh", type=float, default=0.6)
    parser.add_argument("--nms_thresh", type=float, default=0.3)
    parser.add_argument("--arch", default="resnet101", choices=("resnet101", "resnet50"),
                        help="backbone (reference model.py:13 base_model knob)")
    parser.add_argument("--output", default="", help="save annotated image here instead of .show()")
    parser.add_argument("--transfer", default="rgb", choices=("rgb", "yuv420", "jpegdct", "jpegdct4"),
                        help="wire format; only rgb is ported")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    return parser.parse_args(argv)


def run(model, image, templates, prob_thresh, nms_thresh, *, device, transfer="rgb"):
    """(N, 5) detections of one image at scale 1."""
    detector = PyramidDetector(model, templates, cfg=DetectorConfig(), ec=EvalConfig(),
                               device=device, transfer=transfer)
    return detector.detect(np.asarray(image), prob_thresh, nms_thresh, scales=(0,))


def main(argv=None):
    args = arguments(argv)
    from PIL import Image, ImageDraw

    templates = load_templates()
    model = get_model(args.checkpoint, num_templates=templates.shape[0], arch=args.arch,
                      device=args.device)
    print("Loaded model", args.checkpoint)

    image = Image.open(args.image_path).convert("RGB")
    dets = run(model, image, templates, args.prob_thresh, args.nms_thresh, device=args.device,
               transfer=args.transfer)
    print(f"{dets.shape[0]} detections")

    draw = ImageDraw.Draw(image)
    for det in dets:
        draw.rectangle(((det[0], det[1]), (det[2], det[3])), width=4)

    if args.output:
        image.save(args.output)
        print("Saved", args.output)
    else:
        image.show()


if __name__ == "__main__":
    main()

"""Offline template clustering CLI of the port — the surface of
tools/cluster_templates.py:

    python -m tinyfaces_tpu_torch.tools.cluster_templates wider_face_train_bbx_gt.txt \\
        [--num-templates 25] [--out tinyfaces_tpu_torch/data/templates.json]

Reference flow (datasets/__init__.py:23-36, clustering/cluster.py): gather
all train GT boxes, k-medoids for k=25, write templates.json. The natural-
scale column (0.5/1/2) of the shipped templates comes from Hu's release;
regenerated templates get scale column 1.0 with a warning (retraining with
regenerated templates redefines the template id -> scale mapping).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tinyfaces_tpu_torch.clustering.cluster import BACKENDS, compute_kmedoids
from tinyfaces_tpu_torch.data import TEMPLATE_FILE
from tinyfaces_tpu_torch.data.wider_face import WIDERFace


def arguments(argv=None):
    parser = argparse.ArgumentParser("Template clustering")
    parser.add_argument("traindata", help="wider_face_train_bbx_gt.txt")
    parser.add_argument("--num-templates", type=int, default=25)
    parser.add_argument("--out", default=str(TEMPLATE_FILE))
    parser.add_argument("--max-limit", type=int, default=5000)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--option", default="local", choices=tuple(BACKENDS),
                        help="k-medoids backend (reference cluster.py:39-44; "
                             "pyclustering/pyclust map to the PAM backend)")
    return parser.parse_args(argv)


def main(argv=None) -> np.ndarray:
    args = arguments(argv)
    dataset = WIDERFace(args.traindata, np.zeros((0, 5)), split="train")
    bboxes = dataset.get_all_bboxes()
    print(f"{bboxes.shape[0]} GT boxes")

    clustering = compute_kmedoids(
        bboxes, 1, option=args.option, indices=args.num_templates,
        max_clusters=args.num_templates, max_limit=args.max_limit,
        seed=args.seed,
    )
    medoids = np.asarray(clustering[args.num_templates]["medoids"])
    print("Canonical bounding boxes computed")

    # Sort by area (large->small) and attach the natural-scale column.
    areas = (medoids[:, 2] - medoids[:, 0]) * (medoids[:, 3] - medoids[:, 1])
    medoids = medoids[np.argsort(-areas)]
    templates = np.concatenate([medoids, np.ones((medoids.shape[0], 1))], axis=1)
    print("WARNING: regenerated templates carry natural scale 1.0; "
          "the shipped templates.json uses Hu's 0.5/1/2 assignment.")

    with open(args.out, "w") as f:
        json.dump(templates.tolist(), f, indent=1)
    print("Wrote", args.out)
    return templates


if __name__ == "__main__":
    main()

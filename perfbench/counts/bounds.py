"""The least time two hand kernels of the port could take on an H100 SXM,
from what their inputs need: the yardstick of `n1_roofline` and
`k1_roofline`. Each is the larger of an operation bound and a byte bound.

N1 (greedy NMS over the pyramid's candidates): every pair of rows an image
keeps must be shown not to overlap, K (K - 1) / 2 IoU tests of 14 fp32
operations at one issue slot each; the tests that suppressed rows need
cannot be seen from the outside, so the count is a lower bound. Bytes: each
row's box (16 B) and validity (1 B) read once and its keep flag (1 B)
written once.

K1 (dense IoU ground-truth assignment of a train step): about 15 fp32
operations per (anchor, valid ground truth) pair at the 67 TFLOP/s fp32
rate; bytes: the ground truths, their validity, the templates and the seeds
read once, the per-anchor max and argmax and the per-GT max and argmax
written once.
"""

from __future__ import annotations

from typing import Sequence

from perfbench.counts.peaks import PEAKS

H100 = PEAKS["NVIDIA H100 80GB HBM3"]
N1_OPS_PER_TEST = 14
N1_ROW_BYTES = 16 + 1 + 1
K1_OPS_PER_PAIR = 15


def n1_bound_s(rows: int, kept_per_image: Sequence[int]) -> float:
    """Seconds for one call over len(kept_per_image) images of `rows`
    candidate rows each, keeping kept_per_image[i] rows of image i."""
    tests = sum(k * (k - 1) // 2 for k in kept_per_image)
    ops_s = N1_OPS_PER_TEST * tests / H100["fp32_issue"]
    bytes_s = len(kept_per_image) * rows * N1_ROW_BYTES / H100["hbm_bytes"]
    return max(ops_s, bytes_s)


def k1_bound_s(valid_gts: int, batch: int, max_gt: int, anchors: int, templates: int) -> float:
    """Seconds for one call over a batch of `batch` images padded to
    `max_gt` ground truths, `valid_gts` of them valid in all, with `anchors`
    (Y * X * T) anchors an image and `templates` templates."""
    ops_s = K1_OPS_PER_PAIR * valid_gts * anchors / H100["fp32_flops"]
    nbytes = (batch * max_gt * 16 + batch * max_gt + templates * 16 + batch * 4
              + batch * anchors * 8 + batch * max_gt * 8)
    return max(ops_s, nbytes / H100["hbm_bytes"])

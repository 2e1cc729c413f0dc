"""Ground-truth overflow accounting.

The reference processor handles an unbounded number of GT boxes per crop
(tinyfaces/datasets/processor.py:213-277); the train step pads to the
static bound `DetectorConfig.max_gt`. Dense WIDER images (parades) can
exceed any fixed bound, and silently dropping positives would bias
training with no signal, so every truncation is counted here, by both the
Python augmentation (wider_face.augment_draws) and the C++ engine's
wrapper (data/native.py), and surfaced by a one-time warning, the
trainer's epoch log and its `epoch_end` metrics record. A copy of
tinyfaces_tpu/data/overflow.py.
"""

from __future__ import annotations

import threading
import warnings

_lock = threading.Lock()
_dropped_boxes = 0
_truncated_samples = 0
_warned = False


def record(n_kept: int, max_gt: int) -> None:
    """Record one augmented sample's GT count vs the static bound."""
    if n_kept <= max_gt:
        return
    global _dropped_boxes, _truncated_samples, _warned
    with _lock:
        _dropped_boxes += n_kept - max_gt
        _truncated_samples += 1
        first = not _warned
        _warned = True
    if first:
        warnings.warn(
            f"GT truncation: a crop produced {n_kept} ground-truth boxes but "
            f"max_gt={max_gt}; excess boxes are dropped (counted — see "
            f"data.overflow.snapshot()). Raise DetectorConfig.max_gt if this "
            f"is frequent.",
            RuntimeWarning,
            stacklevel=3,
        )


def snapshot() -> dict:
    """{'dropped_boxes': total boxes dropped, 'truncated_samples': crops hit}."""
    with _lock:
        return {
            "dropped_boxes": _dropped_boxes,
            "truncated_samples": _truncated_samples,
        }


def reset() -> None:
    global _dropped_boxes, _truncated_samples, _warned
    with _lock:
        _dropped_boxes = 0
        _truncated_samples = 0
        _warned = False

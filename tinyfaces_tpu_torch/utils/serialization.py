"""Reading the JAX package's flat .npz weight exports.

Keys are '/'-joined paths like 'params/backbone/conv1/kernel' (the format
of tinyfaces_tpu/utils/serialization.save_npz); `unflatten_npz` rebuilds
the nested trees that `utils/convert.from_jax` takes.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def unflatten_tree(flat: Mapping[str, np.ndarray]) -> dict:
    root: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(value)
    return root


def unflatten_npz(npz) -> dict:
    return unflatten_tree({k: npz[k] for k in npz.files})

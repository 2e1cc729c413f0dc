"""A cell of BENCHMARK.json run on the CPU at a tiny size, for the tests:
ResNet stages (1, 1, 1), small images and batches. Never a measurement."""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from perfbench import harness
from perfbench.run import execute, load_cell

TINY_TRAFFIC = {
    "sweep": {"pool": 4, "height": [96, 128], "width": [160, 192], "batch": 2, "depth": 1,
              "calib_images": 2, "check_images": 12},
    "serve": {"pool": 4, "height": [96, 128], "width": [160, 192], "rate": 4, "max_batch": 2,
              "calib_images": 2, "check_images": 8, "drain_s": 30},
    "train": {"images": 3, "width": 320, "height": [240, 320], "repeats": 4, "workers": 2,
              "face_px": [8, 60]},
}
TINY_CONFIG = {"stage_sizes": [1, 1, 1]}
TINY_TRAIN_CONFIG = {"batch_size": 2, "input_size": [128, 128], "heatmap_size": [16, 16], "max_gt": 24}


def decode_jpeg(data: bytes):
    """A library's decode of a JPEG file (PIL), to hold files against."""
    import io

    import numpy as np
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.array(im.convert("RGB"))


def tiny(name: str, root: Path = harness.ROOT, **config_over) -> tuple:
    """The cell (also one of unlisted.json) at the tiny size; `config_over`
    replaces keys of its configuration (as `wire="rgb"`)."""
    bench, cell, config, traffic = load_cell(name, root, unlisted=True)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config.update(TINY_CONFIG, **config_over)
    if "batch_size" in config:
        config.update(TINY_TRAIN_CONFIG)
    traffic.update(TINY_TRAFFIC[traffic["driver"]])
    return bench, cell, config, traffic


def run_tiny(name: str, seed: int = 3, seconds: float = 2.0, trace: bool = False,
             root: Path = harness.ROOT, tmpdir=None, device: str = "cpu", **config_over) -> tuple:
    """(result line, Run) of the cell at the tiny size (on the CPU unless
    `device` names a card)."""
    bench, cell, config, traffic = tiny(name, root, **config_over)
    run = harness.Run(name, config, traffic, seed=seed, seconds=seconds, trace=trace,
                      devices=[torch.device(device)], t_start=time.perf_counter(), tmpdir=tmpdir)
    return execute(run, bench, cell, root), run

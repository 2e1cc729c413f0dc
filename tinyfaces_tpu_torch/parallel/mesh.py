"""Devices of a process and the in-process batch split (port of
tinyfaces_tpu/parallel/mesh.py).

The JAX package meshes over its chips and lets XLA shard the batch. Here a
training rank owns one card (`rank_device`), and a multi-card evaluation
keeps one model replica per card and splits each fused batch over them
(`split_batch`, evaluation.PyramidDetector(device=[...])), or splits one
image's rows over them (`shard="spatial"`, parallel/spatial.py).
"""

from __future__ import annotations

from typing import Sequence

import torch

SHARD_MODES = ("batch", "spatial", "auto")


def check_shard(shard: str) -> None:
    if shard not in SHARD_MODES:
        raise ValueError(f"unknown shard mode {shard!r}")


def rank_device(device: torch.device | str, rank: int) -> torch.device:
    """The device of training rank `rank`: on a bare `cuda`, card
    rank % device_count; an explicit `cuda:N` or `cpu` stays as given."""
    device = torch.device(device)
    cards = torch.cuda.device_count()
    if device.type == "cuda" and device.index is None and cards:
        return torch.device("cuda", rank % cards)
    return device


def local_devices(device: torch.device | str) -> list[torch.device]:
    """Every card of this process for a bare `cuda`; otherwise `device`
    alone."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def split_batch(batch: Sequence, n: int) -> list:
    """`batch` (anything sliceable along its first axis) in n equal
    contiguous pieces, in order."""
    b = len(batch)
    if b % n:
        raise ValueError(f"a batch of {b} does not split over {n} devices")
    k = b // n
    return [batch[i * k:(i + 1) * k] for i in range(n)]

"""Spatial partitioning: one image's forward split over several cards.

Port of tinyfaces_tpu/parallel/spatial.py. The JAX package shards the H axis
of the pyramid's input over its mesh and lets GSPMD insert the halo
exchanges around every conv. Here the split is explicit, in one process over
a list of devices, as the batch split of `PyramidDetector(device=[...])` is:

  * **Split.** The level's canvas is cut into contiguous H-slices, one per
    device (`slice_bounds`), on multiples of 16 input rows, so that every
    stride-2 op down to res4 starts each slice on an even row. The last
    slice takes any remainder; with fewer 16-row units than devices some
    devices get no rows and do nothing (GSPMD pads instead; the result is
    the same).
  * **Halo exchange.** Before every op that looks across rows (`conv1`
    7x7/2, the 3x3/2 max pool, each bottleneck's 3x3 conv, the k4/s2
    transpose conv of the score upsample) each slice gathers the rows it
    needs from its neighbours with `Tensor.to(device, non_blocking=True)`.
    PyTorch's copy between cards runs on the source card's current stream
    and orders itself against both cards' current streams with events, so
    a consumer never reads rows still being written. At the image's top and
    bottom a slice pads exactly as the unsharded op pads: zeros for the
    convs, -inf for the max pool. The op then runs with no padding in H.
    1x1 convs (the stride-2 downsample too), eval-mode batch norm, ReLU and
    the residual add are local to a slice.
  * **Transpose conv.** Output rows [2a, 2b) of the k4/s2/p1 upsample need
    input rows [a-1, b+1) (zero rows beyond the image), and the top-left
    crop to res3's grid only ever trims the bottom slice.
  * **Output.** The per-slice score maps, (B, rows, W/8, 5T) float32, are
    gathered to the first device in row order; decode and NMS run there as
    they do unsharded.

A device list may repeat a device (`["cuda:0", "cuda:0"]`, `["cpu"] * 8`):
the same halo code then runs with same-device copies, which is how one card
and the CPU tests exercise it.

cuDNN picks its algorithms per shape, so a slice's rows need not be
bit-equal to the unsharded forward's; they agree to float rounding.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.parallel.mesh import SHARD_MODES

ALIGN = 16  # input rows per unit of the split: res4 is 1/16 of the input


def choose_mode(n_devices: int, batch: int, mode: str = "auto") -> str:
    """"batch" or "spatial" for an eval batch over `n_devices` (JAX's
    choose_eval_sharding): "auto" is spatial when the batch is smaller
    than the device count, else batch."""
    if mode not in SHARD_MODES:
        raise ValueError(f"unknown eval sharding mode {mode!r}")
    if mode == "auto":
        return "spatial" if batch < n_devices else "batch"
    return mode


def slice_bounds(height: int, n: int, align: int = ALIGN) -> list[tuple[int, int]]:
    """[start, stop) rows of each of `n` slices of `height` rows: whole
    `align`-row units spread as evenly as they go, the remainder in the
    last slice, empty slices where there are fewer units than slices."""
    units = -(-height // align)
    cuts = [min(height, (i * units // n) * align) for i in range(n + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


class Rows(NamedTuple):
    """A (B, C, H, W) activation as contiguous H-slices: `parts[i]` holds
    rows bounds[i] = [start, stop) on the i-th device, or None when empty."""

    parts: list
    bounds: list
    height: int


def scatter(x: torch.Tensor, devices: Sequence[torch.device], align: int = ALIGN) -> Rows:
    """x (B, C, H, W) cut into slices (slice_bounds), one per device."""
    bounds = slice_bounds(x.shape[2], len(devices), align)
    parts = [x[:, :, a:b].to(d, non_blocking=True) if b > a else None
             for (a, b), d in zip(bounds, devices)]
    return Rows(parts, bounds, x.shape[2])


def gather(x: Rows, device: torch.device, dim: int = 2) -> torch.Tensor:
    """The slices joined in row order on `device` (rows along `dim`)."""
    return torch.cat([p.to(device, non_blocking=True) for p in x.parts if p is not None], dim)


def _take(x: Rows, lo: int, hi: int, device: torch.device, fill: float) -> torch.Tensor:
    """Rows [lo, hi) of the whole activation on `device`; rows outside
    [0, height) are `fill`. One slice's own rows come back as a view."""
    ref = next(p for p in x.parts if p is not None)

    def pad(n):
        return torch.full((ref.shape[0], ref.shape[1], n, ref.shape[3]), fill, dtype=ref.dtype,
                          device=device)

    pieces = [pad(-lo)] if lo < 0 else []
    for p, (a, b) in zip(x.parts, x.bounds):
        r0, r1 = max(lo, a), min(hi, b)
        if p is not None and r1 > r0:
            pieces.append(p[:, :, r0 - a:r1 - a].to(device, non_blocking=True))
    if hi > x.height:
        pieces.append(pad(hi - x.height))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, 2)


class _Walk:
    """The detector's eval forward over Rows, one model replica per slice
    (modules looked up by name, so each slice uses its own device's
    weights)."""

    def __init__(self, models: Sequence[TinyFacesDetector]):
        self.models = list(models)
        self.devices = [next(m.parameters()).device for m in self.models]

    def mod(self, i: int, name: str) -> torch.nn.Module:
        return self.models[i].get_submodule(name)

    def local(self, x: Rows, fn) -> Rows:
        """fn(i, part) on every non-empty slice; rows keep their bounds."""
        return x._replace(parts=[None if p is None else fn(i, p) for i, p in enumerate(x.parts)])

    def module(self, x: Rows, name: str) -> Rows:
        """An elementwise or 1x1/stride-1 module applied slice by slice."""
        return self.local(x, lambda i, p: self.mod(i, name)(p))

    def rows_op(self, x: Rows, fn, k: int, s: int, p: int, fill: float) -> Rows:
        """An op of kernel k, stride s and padding p in H: each slice
        gathers the rows its output rows read (its halo) and runs fn(i,
        rows) with no H padding."""
        out_h = (x.height + 2 * p - k) // s + 1

        def edge(r: int) -> int:
            if r == x.height:
                return out_h
            if r % s:
                raise ValueError(f"slice boundary {r} is not a multiple of the stride {s}")
            return r // s

        bounds = [(edge(a), edge(b)) for a, b in x.bounds]
        parts = []
        for i, (o0, o1) in enumerate(bounds):
            if o1 <= o0:
                parts.append(None)
                continue
            lo, hi = o0 * s - p, (o1 - 1) * s - p + k
            parts.append(fn(i, _take(x, lo, hi, self.devices[i], fill)))
        return Rows(parts, bounds, out_h)

    def conv(self, x: Rows, name: str) -> Rows:
        c = self.mod(0, name)

        def fn(i, rows):
            m = self.mod(i, name)
            bias = None if m.bias is None else m.bias.to(rows.dtype)
            return F.conv2d(rows, m.weight.to(rows.dtype), bias, m.stride, (0, m.padding[1]),
                            m.dilation, m.groups)

        return self.rows_op(x, fn, c.kernel_size[0], c.stride[0], c.padding[0], 0.0)

    def max_pool(self, x: Rows) -> Rows:
        """models/resnet.max_pool_3x3_s2: pad 1 of -inf."""
        return self.rows_op(x, lambda i, rows: F.max_pool2d(rows, 3, 2, padding=(0, 1)),
                            3, 2, 1, float("-inf"))

    def bottleneck(self, x: Rows, name: str) -> Rows:
        """models/resnet.Bottleneck.forward over slices."""
        relu = lambda i, p: F.relu(p)  # noqa: E731
        identity = x
        if self.mod(0, name).downsample is not None:
            identity = self.module(self.conv(x, f"{name}.downsample.0"), f"{name}.downsample.1")
        y = self.local(self.module(self.conv(x, f"{name}.conv1"), f"{name}.bn1"), relu)
        y = self.local(self.module(self.conv(y, f"{name}.conv2"), f"{name}.bn2"), relu)
        y = self.module(self.conv(y, f"{name}.conv3"), f"{name}.bn3")
        if y.bounds != identity.bounds:
            raise AssertionError(f"residual slices {y.bounds} != {identity.bounds}")
        return self.local(y, lambda i, p: F.relu(p + identity.parts[i]))

    def upsample(self, x: Rows, name: str) -> Rows:
        """models/detection.DepthwiseConvTranspose2x (k4, s2, p1): output
        rows [2a, 2b) of input rows [a, b) read input rows [a-1, b+1)."""
        parts = []
        for i, (p, (a, b)) in enumerate(zip(x.parts, x.bounds)):
            if p is None:
                parts.append(None)
                continue
            rows = _take(x, a - 1, b + 1, self.devices[i], 0.0)
            w = self.mod(i, name).weight.to(rows.dtype)
            y = F.conv_transpose2d(rows, w, stride=2, padding=(0, 1), groups=rows.shape[1])
            parts.append(y[:, :, 3:3 + 2 * (b - a)])
        return Rows(parts, [(2 * a, 2 * b) for a, b in x.bounds], 2 * x.height)

    def forward(self, x: torch.Tensor, stem_precomputed: bool) -> torch.Tensor:
        """models/detection.TinyFacesDetector.forward over slices; x NCHW."""
        first = self.models[0]
        if first.model.dtype is not None:
            x = x.to(first.model.dtype)
        # conv1's output is 1/2 of the input: its slices are cut on 8-row units
        h = scatter(x, self.devices, ALIGN // 2 if stem_precomputed else ALIGN)
        if not stem_precomputed:
            h = self.conv(h, "model.conv1")
        h = self.local(self.module(h, "model.bn1"), lambda i, p: F.relu(p))
        h = self.max_pool(h)
        res3 = None
        for stage, n in zip(("layer1", "layer2", "layer3"), first.stage_sizes):
            for j in range(n):
                h = self.bottleneck(h, f"model.{stage}.{j}")
            if stage == "layer2":
                res3 = h
        score3 = self.module(res3, "score_res3")
        score4 = self.upsample(self.module(h, "score_res4"), "score4_upsample")
        out = []
        for p3, p4, (a3, b3), (a4, _) in zip(score3.parts, score4.parts, score3.bounds,
                                             score4.bounds):
            if p3 is None:
                out.append(None)
                continue
            if a4 != a3:
                raise AssertionError(f"score slices start at {a3} and {a4}")
            # the top-left crop to res3's grid trims only the bottom slice in H
            p4 = p4[:, :, :b3 - a3, :p3.shape[3]]
            out.append((p3 + p4).permute(0, 2, 3, 1).float())
        return gather(score3._replace(parts=out), self.devices[0], dim=1)


def spatial_forward(models: Sequence[TinyFacesDetector], x: torch.Tensor,
                    stem_precomputed: bool = False) -> torch.Tensor:
    """The detector's eval forward with x's H axis split over the models'
    devices (one replica per slice, in slice order; a device may repeat).
    x: (B, 3, H, W) NCHW, or conv1's (B, 64, H/2, W/2) output with
    `stem_precomputed`, on any device. Returns (B, H/8, W/8, 5T) float32
    on the first model's device, as `models[0](...)` would."""
    with torch.no_grad():
        return _Walk(models).forward(x, stem_precomputed)


"""What the speed instruments share (`bench`, `bench_train`, `tools/*`).

* `resolve_device`: the `--device` of every instrument; `cuda` needs a card
  and nothing carries on on the CPU without one;
* `card`: the card's name and power limit as `nvidia-smi` gives them, the
  label every number measured on it carries; `device_name`: torch's name;
* `sync`, `peak_gib`, `cuda_events_ms`: device clocks and memory;
* `jpeg_bytes`: synthetic JPEG files, the one place PIL is needed (the
  instrument exits naming PIL when it is missing);
* `check_transfer`: the exit for a wire an instrument does not take;
  `pyramid_inputs`: a pyramid's inputs on a wire;
* `build_detector`: the pyramid with seeded weights, as the JAX benches'
  `get_model`.
"""

from __future__ import annotations

import io
import subprocess
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES

PYRAMID_WIRES = ("jpegdct", "jpegdct4", "rgb", "yuv420")  # what PyramidDetector takes


def resolve_device(name: str) -> torch.device:
    """torch.device of `--device`; exits when it names CUDA and there is no
    card."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: torch.cuda.is_available() is False; this "
                         f"instrument measures a GPU (--device cpu runs it on the CPU)")
    return dev


def card(dev: torch.device) -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[dev.index or 0]


def device_name(dev: torch.device) -> str:
    """torch.cuda.get_device_name of a card, "cpu" for the CPU."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_gib(dev: torch.device) -> Optional[float]:
    """Peak device memory since reset_peak, GiB (None on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None


def cuda_events_ms(fn: Callable[[], object], runs: int) -> float:
    """Median over `runs` of fn()'s device time between two CUDA events."""
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def jpeg_bytes(images: Sequence[np.ndarray], quality: int = 90, subsampling: int = 2) -> list:
    """JPEG files of uint8 (H, W, 3) images (PIL, 4:2:0 by default)."""
    try:
        from PIL import Image
    except ImportError:
        raise SystemExit("this instrument writes synthetic JPEG files with PIL, "
                         "which is not installed") from None
    out = []
    for im in images:
        buf = io.BytesIO()
        Image.fromarray(im).save(buf, "JPEG", quality=quality, subsampling=subsampling)
        out.append(buf.getvalue())
    return out


def pyramid_inputs(transfer: str, images: Sequence[np.ndarray], quality: int = 90) -> list:
    """The pyramid's inputs on `transfer`: JPEG files (q`quality`, 4:2:0)
    on the JPEG wires, the uint8 arrays themselves on rgb and yuv420."""
    return jpeg_bytes(images, quality) if transfer.startswith("jpegdct") else list(images)


def check_transfer(transfer: str, taken: Sequence[str]) -> None:
    """Exit for a wire the instrument does not take."""
    if transfer not in taken:
        raise SystemExit(f"unknown transfer {transfer!r}; choose one of {tuple(taken)}")


def build_detector(device: torch.device, *, transfer: str = "jpegdct",
                   dtype: Optional[torch.dtype] = torch.bfloat16,
                   stage_sizes: Sequence[int] = RESNET101_STAGES):
    """PyramidDetector over a TinyFacesDetector with seeded weights
    (generator seed 0) and `EvalConfig()`."""
    from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
    from tinyfaces_tpu_torch.data import load_templates
    from tinyfaces_tpu_torch.evaluation import PyramidDetector
    from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model

    model = TinyFacesDetector(stage_sizes=stage_sizes, dtype=dtype)
    init_model(model, torch.Generator().manual_seed(0))
    return PyramidDetector(model.to(device).eval(), load_templates(), DetectorConfig(),
                           EvalConfig(), device=device, transfer=transfer)

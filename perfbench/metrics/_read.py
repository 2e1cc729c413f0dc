"""What the per-layer readers share. A reader returns None where its run
holds nothing to read (no trace, no such kernel, no such span, an unknown
card), and the metric is then left out of the line."""

from __future__ import annotations

from typing import Optional

from perfbench import tracefile
from perfbench.counts.peaks import peak


def span_mean_ms(run, name: str) -> Optional[float]:
    d = run.spans.durations.get(name)
    return 1e3 * sum(d) / len(d) if d else None


def idle_pct(run) -> Optional[float]:
    s = run.trace_summary
    if not s or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def device_kind(run) -> str:
    import torch

    return torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu"


def mfu_pct(run, rate_key: str, kind: str) -> Optional[float]:
    p = peak(device_kind(run), kind)
    rate = run.e2e.get(rate_key)
    f = run.counters.get("flops_per_item")
    if not (p and rate and f):
        return None
    return 100.0 * f * rate / (p * len(run.devices))


def roofline_pct(run, kernels: tuple, calls_of: tuple, bound_key: str) -> Optional[float]:
    """Bound seconds of each call times the calls in the trace, over the
    summed device time of `kernels` there."""
    s = run.trace_summary
    bound = run.counters.get(bound_key)
    if not s or bound is None:
        return None
    secs, _ = tracefile.kernel_time(s, kernels)
    _, calls = tracefile.kernel_time(s, calls_of)
    if secs <= 0 or calls == 0:
        return None
    return 100.0 * bound * calls / secs

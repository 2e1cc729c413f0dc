"""What the readers of the port's own spans share: the spans
(tinyfaces_tpu_torch/utils/profiling.py, recorded while the traced run's
profiler records) that started and ended inside the traced window, from
`run.t0` for the trace's `window_s`. A span still open at the window's
close runs on through the trace's saving and reading (tens of seconds in
which the main thread holds the GIL), so it is left out. A port without
spans reads as none, and the metric is left out of the line: a traced run
lays the benchmark's newest files over an older checkout of the port too,
whose profiling module has no `spans`."""

from __future__ import annotations

from typing import Optional


def in_window(run) -> list:
    from tinyfaces_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None or run.t0 is None or not run.trace_summary:
        return []
    t0, t1 = run.t0, run.t0 + run.trace_summary["window_s"]
    return [s for s in read() if t0 <= s.start and s.end <= t1]


def window_spans(run, name: str) -> list:
    return [s for s in in_window(run) if s.name == name]


def mean_ms(spans: list) -> Optional[float]:
    return 1e3 * sum(s.end - s.start for s in spans) / len(spans) if spans else None

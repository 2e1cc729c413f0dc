"""What every cell shares: finding a cell's files by name, the run's clock
and spans, the traced window, the metric readers and the result line.

A cell is an entry of BENCHMARK.json's `workloads`: a configuration
(`configs/<config>.json`) under a traffic mix (`traffic/<traffic>.json`,
which names its driver, `drivers/<driver>.py`). A per-layer metric is read
by `metrics/<metric>.py`. Nothing here knows a cell, a mix or a metric by
name.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyfaces_tpu")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(name: str, bench: dict) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(cell: str, entries: list) -> list:
    """The metrics of `entries` that cell reports: those that list it, and
    those that list no cells."""
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def load_module(path: Path):
    """A module from a file (names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_file_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


class Spans:
    """The harness's spans around its calls into the port: durations kept
    in memory by name; in a traced run also `record_function` annotations
    (`perfbench.<name>`) for the profiler."""

    def __init__(self, annotate: bool):
        self.annotate = annotate
        self.durations: dict = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        if self.annotate:
            import torch

            with torch.profiler.record_function("perfbench." + name):
                yield
        else:
            yield
        self.durations[name].append(time.perf_counter() - t0)


class Run:
    """One run of a cell, handed to the module that drives it
    (drivers/<name>.py), which builds the system, calls `begin_window()`
    when set-up is over and `end_window()` once the window has closed; in a
    traced run the profiler is started just before the window (its start-up
    stays out of it) and covers it whole, annotated `perfbench.window`.

    `counters` are that module's readings for the metric readers; `checks`
    the numbers compared, each (name, value, limit)."""

    def __init__(self, name: str, config: dict, traffic: dict, *, seed: int, seconds: float,
                 trace: bool, devices: list, t_start: float, tmpdir: Optional[Path] = None):
        self.name, self.config, self.traffic = name, config, traffic
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.devices = devices
        self.t_start = t_start
        self.tmpdir = Path(tmpdir or tempfile.gettempdir())
        self.spans = Spans(trace)
        self.counters: dict = {}
        self.e2e: dict = {}
        self.checks: list = []
        self.attempted = self.failed = 0
        self.setup_s: Optional[float] = None
        self.t0: Optional[float] = None
        self.trace_summary: Optional[dict] = None
        self._prof = None
        self._window_rf = None
        self.log = lambda *a: print("#", *a, file=sys.stderr, flush=True)

    @property
    def device(self):
        return self.devices[0]

    def begin_window(self) -> float:
        if self.trace and self._prof is None:
            self._start_profiler()
        self.t0 = time.perf_counter()
        if self.setup_s is None:
            self.setup_s = self.t0 - self.t_start
        return self.t0

    def deadline(self) -> float:
        return self.t0 + self.seconds

    def _start_profiler(self) -> None:
        """The Kineto profiler (CPU and CUDA activity). Its results are
        saved by the library itself at the close (`_disable_profiler` then
        `save`): turning the hundreds of thousands of device events of a
        30 s window into Python objects first, as `torch.profiler`'s stop
        does, takes minutes."""
        import torch

        cuda = self.device.type == "cuda"
        self._prof = torch.autograd.profiler.profile(use_device="cuda" if cuda else None, use_kineto=True)
        self._prof._prepare_trace()
        self._prof._start_trace()
        self._window_rf = torch.profiler.record_function("perfbench.window")
        self._window_rf.__enter__()

    def end_window(self) -> None:
        """Close the profiled window (the device drained inside it) and
        summarise its trace."""
        if not self.trace or self._prof is None:
            return
        import torch

        from perfbench import tracefile

        if self.device.type == "cuda":
            for d in self.devices:
                torch.cuda.synchronize(d)
        self._window_rf.__exit__(None, None, None)
        result = torch.autograd._disable_profiler()
        self._prof = None
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            t0 = time.perf_counter()
            result.save(path)
            t1 = time.perf_counter()
            self.trace_summary = tracefile.summarise(path)
            self.log(f"trace: {os.path.getsize(path) / 2**20:.1f} MiB saved in {t1 - t0:.2f} s, "
                     f"read in {time.perf_counter() - t1:.2f} s")
        finally:
            os.unlink(path)


def read_metrics(run: Run, entries: list, metrics_dir: Path = HERE / "metrics") -> dict:
    """Each entry's reader over the run; a reader that finds nothing to
    read returns None and the metric is left out."""
    out = {}
    for m in entries:
        value = load_module(metrics_dir / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_info(run: Run, peak_bytes: int) -> dict:
    import torch

    info = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
            "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda" else "cpu",
            "count": len(run.devices), "memory_peak_bytes": int(peak_bytes)}
    if run.trace and run.trace_summary is not None:
        info["busy_s"] = run.trace_summary["busy_s"]
        info["window_s"] = run.trace_summary["window_s"]
    return info


def memory_peak(devices: list) -> int:
    import torch

    if devices[0].type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in devices)


def checks_block(checks: list) -> dict:
    return {n: {"value": float(v), "limit": float(lim)} for n, v, lim in checks}


def all_within(checks: list) -> bool:
    return all(v <= lim for _, v, lim in checks)



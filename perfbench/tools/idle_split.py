"""The device's idle time per step split by the port's spans, in a traced
run of a cell (not run by the benchmark's own runs).

    python3 perfbench/tools/idle_split.py --workload train-wider-b12 --seed 1 [--seconds 51]

It runs the cell as `run.py --trace 1` does and prints one JSON line:
the traced run's end-to-end readings (`e2e`: tracing's cost when set
beside an untraced run on the same seed), its per-layer `metrics`, and
from the same trace `idle_ms_per_step`, each span name's device-idle ms a
window step (program_idle.split; `none`: under no span of the port), with
its sums over the `train.*` and `loader.*` spans and the window's whole
idle a step, `spans_ms`: each span name's count and mean ms over the
spans inside the traced window, every thread's (metrics/_spans.py), and
`annotations`: the trace's `tinyfaces.*` annotations by name and thread
(which spans reach the trace). Against a port without spans all the idle
reads `none` and `spans_ms` is empty.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness, program_idle, tracefile  # noqa: E402
from perfbench.metrics._spans import in_window  # noqa: E402
from perfbench.run import T_START, cache_env, execute, load_cell  # noqa: E402


class SplitRun(harness.Run):
    """A traced Run that also splits its trace's idle time by span: the
    harness's close of the window (Run.end_window), with the saved trace
    parsed once here for `tracefile.summarise` and `program_idle.split`.
    Temporary, as is program_idle.py: both go once `summarise` gives
    `program_idle` itself (PERF.md, Open questions)."""

    program_idle: dict | None = None
    annotations: dict | None = None

    def end_window(self) -> None:
        if not self.trace or self._prof is None:
            return
        import torch

        if self.device.type == "cuda":
            for d in self.devices:
                torch.cuda.synchronize(d)
        self._window_rf.__exit__(None, None, None)
        result = torch.autograd._disable_profiler()
        self._prof = None
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.tmpdir)
        os.close(fd)
        try:
            result.save(path)
            trace = json.loads(Path(path).read_text())
        finally:
            os.unlink(path)
        self.trace_summary = tracefile.summarise(trace)
        self.program_idle = program_idle.split(trace)
        self.annotations = annotation_counts(trace)


def annotation_counts(trace: dict) -> dict:
    """{"<name> tid <tid>": count} of the trace's `tinyfaces.*` user annotations."""
    return dict(collections.Counter(
        f"{e['name'][len(program_idle.PREFIX):]} tid {e.get('tid')}" for e in trace.get("traceEvents", [])
        if e.get("cat") == "user_annotation" and e.get("name", "").startswith(program_idle.PREFIX)))


def window_spans_ms(run) -> dict:
    by_name = collections.defaultdict(list)
    for s in in_window(run):
        by_name[s.name].append(s.end - s.start)
    return {n: [len(d), 1e3 * sum(d) / len(d)] for n, d in sorted(by_name.items())}


def report(run, line: dict) -> dict:
    steps = run.counters["window_steps"]
    per_step = {n: 1e3 * v / steps for n, v in sorted(run.program_idle.items())}
    s = run.trace_summary
    return {"seed": run.seed, "e2e": dict(run.e2e, setup_s=run.setup_s), "metrics": line["metrics"],
            "correct": line["correct"], "window_steps": steps, "idle_ms_per_step": per_step,
            "idle_in_step_ms": sum(v for n, v in per_step.items() if n.startswith("train.")),
            "idle_in_loader_ms": sum(v for n, v in per_step.items() if n.startswith("loader.")),
            "window_idle_ms_per_step": 1e3 * (s["window_s"] - s["busy_s"]) / steps,
            "spans_ms": window_spans_ms(run), "annotations": run.annotations, "device": line["device"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float)
    args = ap.parse_args(argv)
    cache_env()
    bench, cell, config, traffic = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("idle_split: no CUDA device")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = SplitRun(args.workload, config, traffic, seed=args.seed,
                   seconds=args.seconds or bench["run_seconds"], trace=True, devices=[device],
                   t_start=T_START)
    out = report(run, execute(run, bench, cell))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()

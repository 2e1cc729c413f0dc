"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration and its traffic
mix; the mix names the module (drivers/<name>.py) that builds the port,
warms every shape the mix uses, runs the window and compares what the
timed path produced with the plain reference (reference/). `--trace 0`
reports the cell's end-to-end metrics, `--trace 1` its per-layer metrics
(metrics/<name>.py), read from a profiler trace of the whole window and
from the harness's spans.

The last line on stdout is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 breakdown, and last `checks`, each number
compared beside its limit (also the last lines on stderr). The run exits
non-zero with no result when there is no card (or fewer than the cell
asks for), when that module fails, or when a module whose top-level name is
jax, jaxlib, flax or tinyfaces_tpu is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def cache_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    flax from any library."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton_cache"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))


def load_cell(name: str, root: Path = ROOT, unlisted: bool = False) -> tuple[dict, dict, dict, dict]:
    """(manifest, cell, configuration, mix) of a cell of BENCHMARK.json; with
    `unlisted` also of one that `unlisted.json` keeps out of it (the tools'
    and the tests' use, never a run's)."""
    bench = harness.manifest(root)
    if unlisted and name not in {w["name"] for w in bench["workloads"]}:
        extra = json.loads((root / "perfbench" / "unlisted.json").read_text())
        bench = dict(bench, configs=bench["configs"] + extra["configs"],
                     workloads=bench["workloads"] + extra["workloads"])
    cell = harness.cell_of(name, bench)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, traffic


def execute(run: harness.Run, bench: dict, cell: dict, root: Path = ROOT) -> dict:
    """Drive the cell and assemble its result line (without printing)."""
    driver = harness.load_module(root / "perfbench" / "drivers" / f"{run.traffic['driver']}.py")
    driver.run(run)
    e2e_names = [m["name"] for m in harness.metrics_for(cell["name"], bench["end_to_end"])]
    if run.trace:
        metrics = harness.read_metrics(run, harness.metrics_for(cell["name"], bench["per_layer"]),
                                       root / "perfbench" / "metrics")
    else:
        units = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        values = dict(run.e2e, setup_s=run.setup_s)
        metrics = {n: {"value": float(values[n]), "unit": units[n]} for n in e2e_names if n in values}
    line = {"correct": bool(run.checks) and harness.all_within(run.checks),
            "attempted": int(run.attempted), "failed": int(run.failed), "metrics": metrics,
            "device": harness.device_info(run, run.counters.get("memory_peak_bytes", 0))}
    if run.trace and run.trace_summary is not None:
        line["breakdown"] = {"device_ops": run.trace_summary["device_ops"],
                             "idle_gaps": run.trace_summary["idle_gaps"]}
    line["checks"] = harness.checks_block(run.checks)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    bench, cell, config, traffic = load_cell(args.workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(chips)]
    torch.cuda.set_device(devices[0])
    run = harness.Run(args.workload, config, traffic, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), devices=devices, t_start=T_START)
    try:
        line = execute(run, bench, cell)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the benchmark must not load: {bad}", file=sys.stderr)
        return 4
    for n, v, lim in run.checks:
        print(f"check {n} = {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

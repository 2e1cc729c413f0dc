"""The serve cell's sweep of offered rates, run once when its rate is set.

    python3 perfbench/tools/sweep_rate.py --workload eval-serve-poisson --seed 5 \
        --seconds 15 --rates 40,50,60,70,80

One process, one set-up (the cell's own), then one window a rate. For each
rate one JSON line: the achieved rate (requests over the time to the last
answer), p50/p95/p99, and the backlog's trend (median latency of the
window's last fifth of requests over its first fifth). A rate is sustained
when the achieved rate is within 5% of the offered one and the trend under
1.5; the cell's rate is 4/5 of the highest sustained one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.drivers import serve  # noqa: E402
from perfbench.run import cache_env, load_cell  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="eval-serve-poisson")
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cache_env()
    _, _, config, traffic = load_cell(args.workload, unlisted=True)
    if not torch.cuda.is_available():
        raise SystemExit("the sweep is run on the card")
    dev = torch.device("cuda", 0)
    run = harness.Run(args.workload, config, traffic, seed=args.seed, seconds=args.seconds,
                      trace=False, devices=[dev], t_start=time.perf_counter())
    env = serve.start(run)
    rows = []
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            w = serve.window(run, env, rate, key=10 + 2 * i)
            lat = w["latency_ms"]
            fifth = max(1, len(lat) // 5)
            row = {"offered": rate, "n": len(lat),
                   "achieved": len(lat) / (np.nanmax(w["done_at"]) - w["t0"]),
                   "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
                   "p99_ms": float(np.percentile(lat, 99)),
                   "trend": float(np.median(lat[-fifth:]) / np.median(lat[:fifth])),
                   "late_p95_ms": float(np.percentile(w["late_ms"], 95)),
                   "card": harness.device_info(run, 0)["kind"]}
            row["sustained"] = bool(row["achieved"] >= 0.95 * rate and row["trend"] < 1.5)
            print(json.dumps(row), flush=True)
            rows.append(row)
    finally:
        env["service"].close()
    return rows


if __name__ == "__main__":
    main()

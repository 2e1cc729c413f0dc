"""Open-loop single-image requests through `serving.DetectionService`.

Requests arrive on an open-loop Poisson schedule (traffic/generate.arrivals:
a fixed number of requests, the exponential's quantiles as gaps, in an
order drawn once from the mix's `schedule_key`, the same for every seed:
which gaps come together decides the tail, so a seed that reordered them
would change the work), each one JPEG of the pool, drawn by the seed,
submitted by the main thread at its due time. The service groups same-bucket requests (at most `max_batch`,
waiting at most `max_delay_ms`), pads each group to a power of two and
replays that batch's captured pyramid; set-up warms every rung of the
ladder (an eager call and a capture each).

Each request's latency runs from its scheduled send time to its result,
so a late generator or a stall counts against the requests behind it.
`serve_p95_ms` is the 95th percentile over every request due in the
window; one that fails or has not resolved `drain_s` after the window
closed counts as failed, and as missing every limit.
"""

from __future__ import annotations

import math
import time

import numpy as np

from perfbench import harness
from perfbench.drivers import _shared
from perfbench.traffic import generate


def ladder(max_batch: int) -> list:
    n, out = 1, []
    while n <= max_batch:
        out.append(n)
        n *= 2
    return out


def start(run: harness.Run) -> dict:
    """The pool, the weights, the port's detector and its service, every
    rung of the ladder warmed."""
    from tinyfaces_tpu_torch.serving import DetectionService

    t = run.traffic
    env = _shared.eval_setup(run)
    det, pool = env["det"], env["pool"]
    env["service"] = service = DetectionService(det, max_batch=t["max_batch"],
                                                max_delay_ms=t["max_delay_ms"])
    rungs = ladder(t["max_batch"])
    for _ in range(4):
        for n in rungs:
            for _ in range(2):
                for f in [service.submit(pool[i % len(pool)]) for i in range(n)]:
                    f.result()
        if run.device.type != "cuda" or _shared.graphs(det) >= len(rungs):
            return env
    raise RuntimeError(f"set-up captured {_shared.graphs(det)} pyramids, not the {len(rungs)} rungs")


def window(run: harness.Run, env: dict, rate: float, key: int = 3) -> dict:
    """One window of `run.seconds` at `rate` requests a second; waits for
    every answer up to drain_s after the window. Returns the latencies (ms,
    inf where failed), the requests' pool indices and answers, the
    generator's lateness (ms)."""
    service, pool = env["service"], env["pool"]
    due = generate.arrivals(_shared.rng(run.traffic["schedule_key"], key), rate, run.seconds)
    which = _shared.rng(run.seed, key + 1).permutation(np.resize(np.arange(len(pool)), len(due)))
    n = len(due)
    done_at = [math.nan] * n
    sent_at = np.zeros(n)
    futures = []
    run.spans.durations.clear()
    t0 = run.begin_window()
    for k in range(n):
        wait = t0 + due[k] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        sent_at[k] = time.perf_counter()
        with run.spans("submit"):
            f = service.submit(pool[which[k]])

        def finished(f, k=k):
            done_at[k] = time.perf_counter()

        f.add_done_callback(finished)
        futures.append(f)
    limit = run.deadline() + run.traffic["drain_s"]
    answers = []
    for f in futures:
        try:
            answers.append(f.result(timeout=max(0.0, limit - time.perf_counter())))
        except Exception as e:  # a request that fails or never resolves is failed
            run.log(f"request failed: {type(e).__name__}: {e}")
            answers.append(None)
    time.sleep(max(0.0, run.deadline() - time.perf_counter()))
    run.end_window()  # after the answers: the profiler's stop delays none
    lat = np.array([(d - (t0 + s)) * 1e3 if a is not None and d == d else math.inf
                    for d, s, a in zip(done_at, due, answers)])
    return {"latency_ms": lat, "which": which, "answers": answers, "due": due,
            "late_ms": (sent_at - (t0 + due)) * 1e3, "t0": t0, "done_at": np.array(done_at)}


def run(run: harness.Run) -> None:
    t = run.traffic
    env = start(run)
    try:
        w = window(run, env, t["rate"])
    finally:
        env["service"].close()
    run.counters["memory_peak_bytes"] = harness.memory_peak(run.devices)
    lat = w["latency_ms"]
    run.attempted = len(lat)
    run.failed = int(np.isinf(lat).sum())
    p95 = float(np.percentile(lat, 95))
    run.e2e["serve_p95_ms"] = p95 if math.isfinite(p95) else 1e9
    run.log(f"window: {len(lat)} requests due at {t['rate']}/s over {run.seconds} s; p50 "
            f"{np.percentile(lat, 50):.3f} ms, p95 {p95:.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
            f"max {lat.max():.3f} ms; {run.failed} failed; generator late by p95 "
            f"{np.percentile(w['late_ms'], 95):.3f} ms, max {w['late_ms'].max():.3f} ms")
    finished = [(int(w["which"][k]), a) for k, a in enumerate(w["answers"]) if a is not None]
    checked = _shared.sample(run, finished, t["check_images"])
    _shared.release(env)
    t1 = time.perf_counter()
    _shared.add_checks(run, _shared.reference_numbers(run, env, checked))
    run.log(f"reference check of {len(checked)} requests: {time.perf_counter() - t1:.2f} s")

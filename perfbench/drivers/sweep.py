"""Closed-loop batch detection: the WIDER sweep's pipeline.

A pack thread runs `PyramidDetector.pack_inputs` (the host's JPEG entropy
decode and pack) at most `depth` batches ahead; one dispatch thread runs
`detect_batch_async` (upload, the replayed pyramid graph, the copy back)
with `depth` batches in flight; the main thread fetches them in order
(`_fetch`). Batch i is the `batch` pool images from position i of the
seed's order, so consecutive batches differ. Set-up warms the one program
key: its eager first call and its capture, both on the dispatch thread.

`pyramid_img_per_s`: the images of the batches fetched within the window
over the time from its start to the last of those fetches.
"""

from __future__ import annotations

import collections
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from perfbench import harness
from perfbench.counts import bounds, flops
from perfbench.drivers import _shared


def run(run: harness.Run) -> None:
    t = run.traffic
    env = _shared.eval_setup(run)
    det, pool = env["det"], env["pool"]
    n, batch, depth = len(pool), t["batch"], t["depth"]
    order = _shared.rng(run.seed, 2).permutation(n).tolist()

    def items(i):
        return [order[(i + j) % n] for j in range(batch)]

    def pack(i):
        with run.spans("pack"):
            return det.pack_inputs([pool[k] for k in items(i)])

    def dispatch(p):
        with run.spans("dispatch"):
            return det.detect_batch_async(p)

    packer, submitter = ThreadPoolExecutor(1), ThreadPoolExecutor(1)
    try:
        for i in range(3):  # eager, capture, replay: on the dispatch thread
            p = pack(n - 1 - i)
            det._fetch(submitter.submit(dispatch, p).result())
        if run.device.type == "cuda" and _shared.graphs(det) != 1:
            raise RuntimeError(f"set-up left {_shared.graphs(det)} captured pyramids, not 1")
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        run.spans.durations.clear()
        canvas = p.h0p, p.w0p
        t0 = run.begin_window()
        deadline = run.deadline()
        packs, flight, done = collections.deque(), collections.deque(), []
        i = images = 0
        t_last = t0
        while True:
            if time.perf_counter() >= deadline:
                break
            packs.append((i, packer.submit(pack, i)))
            i += 1
            if len(packs) <= depth:
                continue
            j, p = packs.popleft()
            flight.append((j, submitter.submit(lambda p=p: dispatch(p.result()))))
            run.attempted += batch
            if len(flight) > depth:
                j, f = flight.popleft()
                with run.spans("fetch"):
                    res = det._fetch(f.result())
                now = time.perf_counter()
                if now <= deadline:
                    done.append((j, res))
                    images += len(res)
                    t_last = now
        for _, f in list(flight) + list(packs):  # in flight at the close: not counted
            f.result()
        run.end_window()
    finally:
        packer.shutdown(wait=True)
        submitter.shutdown(wait=True)
    run.counters["memory_peak_bytes"] = harness.memory_peak(run.devices)
    if not done:
        raise RuntimeError("no batch completed within the window")
    run.e2e["pyramid_img_per_s"] = images / (t_last - t0)
    ev = run.config["eval"]
    rows = len(ev["scales"]) * ev["max_dets_per_scale"]
    run.counters["n1_bound_s_per_call"] = sum(
        bounds.n1_bound_s(rows, [len(d) for d in res]) for _, res in done) / len(done)
    run.counters["flops_per_item"] = flops.pyramid_flops(*canvas, ev["scales"], env["stages"],
                                                         len(env["templates"]))
    run.counters["batches"] = len(done)
    run.log(f"window: {len(done)} batches of {batch} fetched in {t_last - t0:.3f} s, "
            f"{run.e2e['pyramid_img_per_s']:.4f} img/s; dispatched {run.attempted} images")
    flat = [(items(j)[k], res[k]) for j, res in done for k in range(batch)]
    checked = _shared.sample(run, flat, t["check_images"])
    _shared.release(env)
    t1 = time.perf_counter()
    _shared.add_checks(run, _shared.reference_numbers(run, env, checked))
    run.log(f"reference check of {len(checked)} images: {time.perf_counter() - t1:.2f} s")


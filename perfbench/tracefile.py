"""Reading the Chrome trace of a traced window.

The window is the host-side user annotation `perfbench.window` (not its
device-side `gpu_user_annotation` twin); the harness's own
spans are user annotations named `perfbench.<span>` on whichever thread
made the call. `summarise` returns, over that window:

* `window_s`, and `busy_s`: the union of the intervals in which a kernel,
  copy or memset ran on the device (an interval counts once however many
  streams overlap in it), so the idle share is 1 - busy_s / window_s;
* `kernels`: summed device seconds and launch count by kernel name;
* `device_ops`: the ten names that took the most device time;
* `idle_gaps`: the ten longest stretches with nothing on the device, each
  named by the harness spans open at its middle (`idle` where none was).

Kernel names are matched whole (`kernel_is`): the port's K1 is
`reduce_kernel` in an anonymous namespace, and PyTorch's own reductions are
`at::native::reduce_kernel<...>`, which must not count.
"""

from __future__ import annotations

import collections
import json
import re
from pathlib import Path
from typing import Iterable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"
SPAN_PREFIX = "perfbench."
_PLAIN = re.compile(r"^(?:void )?(?:\(anonymous namespace\)::)?([A-Za-z_]\w*)(?:<[^()]*>)?\(")


def kernel_base(name: str) -> str | None:
    """The unqualified name of a kernel defined at file scope or in an
    anonymous namespace (template arguments dropped: K1 is
    `reduce_kernel<true>`), from its demangled trace name; None for a
    kernel in a named namespace such as `at::native::`."""
    m = _PLAIN.match(name)
    return m.group(1) if m else None


def kernel_is(name: str, bases: Iterable[str]) -> bool:
    return kernel_base(name) in set(bases)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarise(trace: dict | str | Path, top: int = 10) -> dict:
    if not isinstance(trace, dict):
        trace = json.loads(Path(trace).read_text())
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError("the trace holds no perfbench.window annotation")
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    kernels: dict = collections.defaultdict(lambda: [0.0, 0])
    intervals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        k = kernels[e["name"]]
        k[0] += (b - a) / 1e6
        k[1] += 1
        intervals.append((a, b))
    busy = _union(intervals)
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith(SPAN_PREFIX)
             and e["name"] != WINDOW]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            open_ = sorted({n for s0, s1, n in spans if s0 <= mid < s1})
            gaps.append(("+".join(open_) or "idle", (b - a) / 1e6))
    gaps.sort(key=lambda g: -g[1])
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": {k: {"s": v[0], "n": v[1]} for k, v in kernels.items()},
        "device_ops": [[k[:160], v[0]] for k, v in ranked[:top]],
        "idle_gaps": [[n[:160], s] for n, s in gaps[:top]],
    }


def kernel_time(summary: dict, bases: Iterable[str]) -> tuple[float, int]:
    """Summed device seconds and launches of the kernels named `bases`."""
    s = n = 0
    for name, v in summary["kernels"].items():
        if kernel_is(name, bases):
            s += v["s"]
            n += v["n"]
    return s, n

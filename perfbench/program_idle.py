"""The device's idle time in a traced window, split by the port's own spans.

The port's spans (tinyfaces_tpu_torch/utils/profiling.py) reach the trace
as user annotations `tinyfaces.<name>` from the thread that started the
profiler, the thread that holds `perfbench.window` and drives the card.
`split` maps each span name to the seconds of the window in which nothing
ran on the device (as `tracefile.summarise` counts `busy_s`) while that
span was the innermost `tinyfaces.` annotation open on that thread; idle
time under no such span goes under `none`. Each idle interval is split at
the spans' edges. Other threads' spans (the loader's producer and workers)
are left out: they do not drive the card.

Temporary, with tools/idle_split.py, its one caller: the split belongs in
`tracefile.summarise` as a key `program_idle`, which has the window and the
busy union at hand (PERF.md, Open questions).
"""

from __future__ import annotations

import collections
import json
from pathlib import Path

from perfbench import tracefile

PREFIX = "tinyfaces."
NONE = "none"


def _labels(spans: list, w0: float, w1: float) -> list:
    """[(a, b, name)]: the window cut where the innermost open span
    changes (ends before starts at one instant)."""
    edges = sorted([(s0, 1, s0 - s1, i) for i, (s0, s1, _) in enumerate(spans)]  # outer first
                   + [(s1, 0, 0, i) for i, (_, s1, _) in enumerate(spans)])
    out, open_, t = [], [], w0
    for x, is_start, _, i in edges:
        x = min(max(x, w0), w1)
        if x > t:
            out.append((t, x, spans[open_[-1]][2] if open_ else NONE))
            t = x
        if is_start:
            open_.append(i)
        else:
            open_.remove(i)
    if w1 > t:
        out.append((t, w1, NONE))
    return out


def split(trace: dict | str | Path) -> dict:
    """{span name: idle seconds} over the window, `none` for idle time under
    no span; the values sum to window_s - busy_s."""
    if not isinstance(trace, dict):
        trace = json.loads(Path(trace).read_text())
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == tracefile.WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        raise ValueError("the trace holds no perfbench.window annotation")
    win = windows[0]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    intervals = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in events
                 if e.get("cat") in tracefile.DEVICE_CATS]
    busy = tracefile._union([iv for iv in intervals if iv[1] > iv[0]])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)
             and (e.get("pid"), e.get("tid")) == (win.get("pid"), win.get("tid"))]
    out: dict = collections.defaultdict(float)
    labels = _labels(spans, w0, w1)
    j = 0
    for a, b in idle:  # both lists sorted and disjoint: one pass
        while labels[j][1] <= a:
            j += 1
        k = j
        while k < len(labels) and labels[k][0] < b:
            la, lb, name = labels[k]
            out[name] += (min(b, lb) - max(a, la)) / 1e6
            k += 1
    return dict(out)

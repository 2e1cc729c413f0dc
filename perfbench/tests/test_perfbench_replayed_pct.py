"""The reader of `replayed_pct.train`: the share of the port's `train.step`
spans in the traced window that replayed the captured step, on spans in
the form `main.py --profile-dir` writes (fixtures/replay_spans.json: the
set-up's warm-up and capture before the window, then four replays and a
capture at the staircase's next rate inside it, and a replay the window's
close cuts)."""

import json
import math
from pathlib import Path

from perfbench.harness import HERE, load_module
from tinyfaces_tpu_torch.utils import profiling
from tinyfaces_tpu_torch.utils.profiling import Span

FIXTURE = Path(__file__).parent / "fixtures" / "replay_spans.json"


class FakeRun:
    def __init__(self, t0=100.0, window_s=10.0):
        self.t0 = t0
        self.trace_summary = {"window_s": window_s}


def read(run):
    return load_module(HERE / "metrics" / "replayed_pct.train.py").read(run)


def fixture_spans(drop_path=False):
    out = []
    for i, s in enumerate(json.loads(FIXTURE.read_text())["spans"]):
        attrs = {k: v for k, v in s["attrs"].items() if not (drop_path and k == "path")}
        out.append(Span(s["name"], s["start"], s["end"], "MainThread", i + 1, None, attrs))
    return out


def test_replayed_share_of_the_window_steps(monkeypatch):
    """Steps 2-6 lie in the window, four replays and a capture: 80%."""
    monkeypatch.setattr(profiling, "spans", fixture_spans)
    assert math.isclose(read(FakeRun()), 80.0)
    assert math.isclose(read(FakeRun(t0=101.4, window_s=1.0)), 100.0)  # replays alone


def test_a_port_without_the_path_reads_zero(monkeypatch):
    """The parent's `train.step` spans carry no `path`: every step eager."""
    monkeypatch.setattr(profiling, "spans", lambda: fixture_spans(drop_path=True))
    assert read(FakeRun()) == 0.0


def test_nothing_to_read(monkeypatch):
    monkeypatch.setattr(profiling, "spans", fixture_spans)
    assert read(FakeRun(t0=200.0)) is None  # no step in the window
    run = FakeRun()
    run.trace_summary = None  # no trace
    assert read(run) is None
    monkeypatch.delattr(profiling, "spans")  # a port without spans: none, no error
    assert read(FakeRun()) is None

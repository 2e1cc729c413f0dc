"""The port's own spans in the benchmark: the device's idle time split by
them (program_idle.py) on a small trace whose window's thread holds
`tinyfaces.*` annotations beside another thread's, the readers of the
spans, and a tiny traced train run on the CPU that reports them."""

import math
from pathlib import Path

import pytest
from torch.autograd import profiler as autograd_profiler

from perfbench import program_idle, tracefile
from perfbench.harness import HERE, load_module
from perfbench.tests.tiny import tiny
from tinyfaces_tpu_torch.utils import profiling
from tinyfaces_tpu_torch.utils.profiling import Span

FIXTURES = Path(__file__).parent / "fixtures"
SMALL, PROGRAM = FIXTURES / "small_trace.json", FIXTURES / "program_trace.json"
READERS = ("host_step_ms.train", "loader_batch_ms.train", "loader_starved_pct.train")


class FakeRun:
    def __init__(self, t0=100.0, window_s=10.0):
        self.t0 = t0
        self.trace_summary = {"window_s": window_s}


def read(name, run):
    return load_module(HERE / "metrics" / f"{name}.py").read(run)


def _span(name, start, dur, **attrs):
    return Span(name, start, start + dur, "MainThread", 0, None, attrs)


def test_program_spans_leave_the_summary_as_it_was():
    """Every key of tracefile.summarise reads on the trace with the port's
    annotations what it reads on the trace without them (the values
    test_perfbench_readers.py pins)."""
    s = tracefile.summarise(PROGRAM)
    assert s == tracefile.summarise(SMALL)
    assert math.isclose(s["window_s"], 1e-3) and math.isclose(s["busy_s"], 825e-6)
    assert [g[0] for g in s["idle_gaps"]] == ["loss_read", "idle", "train_step"]
    assert s["device_ops"][0][0].startswith("sm90_xmma_fprop") and math.isclose(s["device_ops"][0][1], 600e-6)


def test_idle_split_by_hand():
    """Idle 1175-1200 (split: targets to 1180, forward after), 1600-1700
    (loader.get 1620-1680 on the window's thread), 1950-2000 (under only
    another thread's span); the span before the window counts nothing."""
    got = program_idle.split(PROGRAM)
    want = {"train.targets": 5e-6, "train.forward": 20e-6, "loader.get": 60e-6, "none": 90e-6}
    assert got.keys() == want.keys()
    for k in want:
        assert math.isclose(got[k], want[k], rel_tol=1e-9), (k, got[k])
    s = tracefile.summarise(PROGRAM)
    assert math.isclose(sum(got.values()), s["window_s"] - s["busy_s"])
    assert program_idle.split(SMALL) == pytest.approx({"none": 175e-6})


def test_idle_split_innermost_span():
    """A parent and its child starting at one instant: the child is the
    innermost; after the child ends, the parent again."""
    ann = lambda name, ts, dur: {"ph": "X", "cat": "user_annotation", "name": name,  # noqa: E731
                                 "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    trace = {"traceEvents": [ann("perfbench.window", 0, 100), ann("tinyfaces.train.forward", 10, 20),
                             ann("tinyfaces.train.step", 10, 60),
                             {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 10, "pid": 1, "tid": 7}]}
    got = program_idle.split(trace)
    assert got == pytest.approx({"train.forward": 20e-6, "train.step": 40e-6, "none": 30e-6})


def test_span_readers(monkeypatch):
    spans = [_span("train.step", 99.0, 0.5),  # before the window: left out
             _span("train.step", 100.0, 0.080), _span("train.step", 101.0, 0.100),
             _span("loader.batch", 100.5, 0.300),
             _span("loader.get", 100.2, 0.001, batch=0, ready=0, first=True),
             _span("loader.get", 100.4, 0.001, batch=1, ready=2, first=False),
             _span("loader.get", 100.6, 0.001, batch=2, ready=1, first=False),
             _span("loader.get", 100.8, 0.050, batch=3, ready=0, first=False),
             _span("loader.get", 109.99, 0.050, batch=4, ready=0, first=False),  # cut by the close: out
             _span("loader.batch", 109.9, 30.0, batch=9)]  # on through the trace's reading: out
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    run = FakeRun()
    assert math.isclose(read("host_step_ms.train", run), 90.0)
    assert math.isclose(read("loader_batch_ms.train", run), 300.0)
    assert math.isclose(read("loader_starved_pct.train", run), 50.0)


@pytest.mark.parametrize("name", READERS)
def test_span_readers_find_nothing(monkeypatch, name):
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert read(name, FakeRun()) is None
    monkeypatch.setattr(profiling, "spans", lambda: [_span("train.step", 1.0, 0.1),
                                                     _span("loader.get", 1.0, 0.1, ready=0)])
    assert read(name, FakeRun()) is None  # none in the window
    run = FakeRun()
    run.trace_summary = None  # no trace
    assert read(name, run) is None
    monkeypatch.delattr(profiling, "spans")  # a port without spans: none, no error
    assert read(name, FakeRun()) is None


def _tiny_train(tmp_path, trace):
    from perfbench.run import execute
    from perfbench.tools.idle_split import SplitRun

    import time

    import torch

    bench, cell, config, traffic = tiny("train-wider-b12")
    traffic["repeats"] = 16  # 24 batches an epoch: the producer works on in the window
    run = SplitRun("train-wider-b12", config, traffic, seed=2**31 + 5, seconds=4.0, trace=trace,
                   devices=[torch.device("cpu")], t_start=time.perf_counter(), tmpdir=tmp_path)
    return execute(run, bench, cell), run


def test_tiny_traced_train_run_reports_the_spans(tmp_path, monkeypatch):
    """On the CPU at a tiny size: the untraced run records no span; the
    traced run reports the three span metrics, and its idle (all of the
    window: no device) is split by the port's spans."""
    from perfbench.tools.idle_split import report

    # the harness stops its profiler without clearing torch's flag: restore it after
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", False)
    profiling.reset()
    line, _ = _tiny_train(tmp_path, trace=False)
    assert line["correct"] and profiling.spans() == []
    line, run = _tiny_train(tmp_path, trace=True)
    assert line["correct"], line["checks"]
    assert set(READERS) <= set(line["metrics"])
    assert line["metrics"]["host_step_ms.train"]["value"] > 0
    assert 0 <= line["metrics"]["loader_starved_pct.train"]["value"] <= 100
    split = run.program_idle
    assert {"train.targets", "train.forward", "train.loss", "train.backward", "train.update",
            "loader.get"} <= set(split)
    s = run.trace_summary
    assert math.isclose(sum(split.values()), s["window_s"] - s["busy_s"], rel_tol=1e-9)
    out = report(run, line)
    assert out["idle_in_step_ms"] > 0 and out["idle_in_loader_ms"] > 0
    assert out["idle_in_step_ms"] + out["idle_in_loader_ms"] <= out["window_idle_ms_per_step"] * (1 + 1e-9)
    assert out["spans_ms"]["train.step"][0] == run.counters["window_steps"]
    assert "loader.decode" in out["spans_ms"] and "loader.augment" in out["spans_ms"]
    names = {k.split(" tid ")[0] for k in out["annotations"]}  # the main thread's spans alone
    assert {"train.step", "train.forward", "loader.get", "loader.upload"} <= names
    assert not names & {"loader.batch", "loader.decode", "loader.augment"}
    profiling.reset()

"""The port's spans (tinyfaces_tpu_torch/utils/profiling.py) on the CPU:
off they record nothing and enter no profiler annotation; on, they record
name, start and end, thread, parent and attributes; under a profiler
started as perfbench's harness starts it, the main thread's spans are
`tinyfaces.*` user annotations of its trace; the loader's and the train
step's spans are where the work is; `trace(logdir)` writes them out."""

import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from tests.test_torch_trainer import CFG, TC, _batch, _dataset, _port_model
from tests.test_torch_wider_train import write_train_tree
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.data import wider_face as wf
from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader, PrefetchLoader
from tinyfaces_tpu_torch.trainer import Trainer
from tinyfaces_tpu_torch.utils import profiling
from tinyfaces_tpu_torch.utils.profiling import span

PHASES = ["train.targets", "train.forward", "train.loss", "train.backward", "train.update"]


@pytest.fixture
def recording():
    """Spans on (enable()), from an empty buffer; off and empty after."""
    profiling.reset()
    profiling.enable()
    yield
    profiling.enable(False)
    profiling.reset()


def _no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def _named(name):
    return [s for s in profiling.spans() if s.name == name]


def test_off_spans_record_nothing(monkeypatch):
    profiling.reset()
    assert not autograd_profiler._is_profiler_enabled
    _no_record_function(monkeypatch)

    def unread():
        raise AssertionError("a callable attribute read while spans are off")

    with span("train.step", step=3):
        with span("loader.get", batch=0, ready=unread):
            pass
    assert profiling.spans() == []


def test_callable_attributes_are_read_at_the_start(recording):
    depth = [2]
    with span("loader.get", batch=0, ready=lambda: depth[0], first=True):
        depth[0] = 1  # a get takes a batch: read at the start, not the end
    (got,) = profiling.spans()
    assert got.attrs == {"batch": 0, "ready": 2, "first": True}


def test_enabled_spans_record_name_parent_thread_attrs(recording, monkeypatch):
    _no_record_function(monkeypatch)  # no profiler records: no annotation
    with span("train.step", step=7):
        with span("train.forward"):
            pass
        with span("train.loss"):
            pass

    def other():
        with span("loader.batch", batch=2):
            pass

    t = threading.Thread(target=other, name="loader producer")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    got = {s.name: s for s in profiling.spans()}
    assert set(got) == {"train.step", "train.forward", "train.loss", "loader.batch"}
    step, fwd, loss, batch = (got[n] for n in ("train.step", "train.forward", "train.loss",
                                               "loader.batch"))
    assert step.parent is None and step.attrs == {"step": 7}
    assert fwd.parent == loss.parent == step.id and fwd.attrs == {}
    assert step.start <= fwd.start <= fwd.end <= loss.start <= loss.end <= step.end
    assert step.thread == threading.current_thread().name
    assert batch.thread == "loader producer" and batch.parent is None and batch.attrs == {"batch": 2}
    assert len({s.id for s in got.values()}) == 4


def test_span_recorded_when_its_work_raises(recording):
    with pytest.raises(ValueError):
        with span("train.step", step=0):
            with span("train.forward"):
                raise ValueError
    with span("train.update"):
        pass
    got = {s.name: s for s in profiling.spans()}
    assert got["train.forward"].parent == got["train.step"].id
    assert got["train.update"].parent is None  # the stack was popped


def test_buffer_is_bounded(recording, monkeypatch):
    import collections

    monkeypatch.setattr(profiling, "_buffer", collections.deque(maxlen=3))
    for i in range(5):
        with span("loader.get", batch=i):
            pass
    assert [s.attrs["batch"] for s in profiling.spans()] == [2, 3, 4]


def test_threads_record_every_span(recording):
    """More threads than cores, a short switch interval: no span lost, ids
    unique, each parent the enclosing span of the same thread."""
    n_threads, n_spans = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_spans):
                with span("loader.decode", index=i, worker=k):
                    with span("loader.augment", index=i, worker=k):
                        pass

        threads = [threading.Thread(target=work, args=(k,), name=f"w{k}") for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.spans()
    assert len(got) == 2 * n_threads * n_spans
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    for s in got:
        if s.name == "loader.augment":
            p = by_id[s.parent]
            assert p.name == "loader.decode" and p.thread == s.thread == f"w{s.attrs['worker']}"
            assert p.attrs == s.attrs and p.start <= s.start <= s.end <= p.end
        else:
            assert s.parent is None


def _harness_profile(tmp_path, work):
    """`work()` under a CPU profiler started and saved as perfbench's
    harness starts and saves it (Run._start_profiler, Run.end_window);
    returns the trace's events."""
    prof = torch.autograd.profiler.profile(use_device=None, use_kineto=True)
    prof._prepare_trace()
    prof._start_trace()
    try:
        work()
    finally:
        result = torch.autograd._disable_profiler()
    path = tmp_path / "trace.json"
    result.save(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_main_thread_spans_are_profiler_annotations(tmp_path, monkeypatch):
    profiling.reset()
    # The harness stops the profiler without clearing torch's flag; restore it.
    monkeypatch.setattr(autograd_profiler, "_is_profiler_enabled", False)

    def work():
        with span("train.step", step=0):
            with span("train.forward"):
                torch.ones(8).sum()

        def other():
            with span("loader.batch", batch=0):
                pass

        t = threading.Thread(target=other, name="loader producer")
        t.start()
        t.join(timeout=30)

    events = _harness_profile(tmp_path, work)
    annotations = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    assert {"tinyfaces.train.step", "tinyfaces.train.forward"} <= set(annotations)
    outer, inner = annotations["tinyfaces.train.step"], annotations["tinyfaces.train.forward"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert outer["tid"] == inner["tid"]
    assert "tinyfaces.loader.batch" not in annotations  # another thread's: in the buffer only
    # every thread's spans are in the buffer, with the profiler's flag alone on
    assert {s.name for s in profiling.spans()} == {"train.step", "train.forward", "loader.batch"}
    profiling.reset()


def test_trace_writes_spans_json(tmp_path):
    profiling.reset()
    with profiling.trace(str(tmp_path)):
        with span("train.step", step=4):
            with span("train.backward"):
                torch.ones(4).sum()
    assert not autograd_profiler._is_profiler_enabled
    out = json.loads((tmp_path / "spans.json").read_text())
    got = {s["name"]: s for s in out["spans"]}
    assert set(got) == {"train.step", "train.backward"}
    assert got["train.step"]["attrs"] == {"step": 4}
    assert got["train.backward"]["parent"] == got["train.step"]["id"]
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert "tinyfaces.train.step" in {e.get("name") for e in trace["traceEvents"]}
    with span("train.step", step=5):  # the profiler has stopped: off again
        pass
    assert len(profiling.spans()) == 2
    profiling.reset()


def _check_epoch(nb):
    gets, batches = _named("loader.get"), _named("loader.batch")
    assert [s.attrs["batch"] for s in gets] == list(range(nb))
    assert sorted(s.attrs["batch"] for s in batches) == list(range(nb))
    assert [s.attrs["first"] for s in gets] == [True] + [False] * (nb - 1)
    assert all(s.attrs["ready"] >= 0 for s in gets)
    assert [s.attrs["batch"] for s in _named("loader.upload")] == list(range(nb))
    by_id = {s.id: s for s in profiling.spans()}
    collates = _named("loader.collate")
    assert sorted(s.attrs["batch"] for s in collates) == list(range(nb))
    for s in collates:
        assert by_id[s.parent].name == "loader.batch" and by_id[s.parent].attrs == s.attrs
    assert {s.thread for s in batches + collates + _named("loader.put")} == {"loader producer"}
    assert {s.thread for s in gets} == {threading.current_thread().name}


@pytest.mark.parametrize("n,batch_size,workers,kw", [
    (7, 2, 2, {}), (9, 3, 1, {}), (4, 1, 3, {}),
    (7, 2, 2, {"pack": "yuv420"}), (9, 4, 2, {"rank": 1, "world": 2})])
def test_loader_epoch_spans(recording, n, batch_size, workers, kw):
    loader = PrefetchLoader(_dataset(n), batch_size, device="cpu", workers=workers, seed=1, **kw)
    for epoch in range(2):
        profiling.reset()
        assert len(list(loader)) == n // batch_size
        _check_epoch(n // batch_size)


def test_loader_abandoned_mid_epoch(recording):
    loader = PrefetchLoader(_dataset(12), 2, device="cpu", workers=2, seed=1)
    it = iter(loader)
    next(it)
    it.close()  # the producer is stopped and drained
    assert [s.attrs["batch"] for s in _named("loader.get")] == [0]
    assert len(list(loader)) == 6


def test_native_loader_worker_spans(recording, tmp_path):
    ann = write_train_tree(tmp_path)
    dataset = wf.WIDERFace(ann, load_templates(), cfg=CFG, dataset_root=tmp_path, seed=3)
    loader = NativePrefetchLoader(dataset, 2, device="cpu", workers=2, seed=5)
    assert len(list(loader)) == 2
    _check_epoch(2)
    used = sorted(int(i) for b in range(2) for i in loader._batch_indices(loader.order(0), b))
    for name in ("loader.decode", "loader.augment"):
        got = _named(name)
        assert sorted(s.attrs["index"] for s in got) == used
        assert all(s.thread.startswith("loader worker") for s in got)


@pytest.mark.parametrize("nan_guard", [False, True])
def test_train_step_phase_spans(recording, nan_guard):
    trainer = Trainer(_port_model(), CFG, TC, load_templates(), device="cpu", seed=0,
                      augment="python", nan_guard=nan_guard)
    trainer.setup(steps_per_epoch=2)
    data = _dataset(4)
    for i in range(2):
        profiling.reset()
        lb = trainer.train_step(_batch(data[2 * i:2 * i + 2]))
        assert np.isfinite(float(lb.total))
        steps = _named("train.step")
        assert len(steps) == 1 and steps[0].attrs == {"step": i, "path": "eager", "tuned": int(i == 0)}
        phases = sorted((s for s in profiling.spans() if s.parent == steps[0].id),
                        key=lambda s: s.start)
        assert [s.name for s in phases] == PHASES
        assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))
        assert steps[0].start <= phases[0].start and phases[-1].end <= steps[0].end


def test_train_epoch_spans(recording):
    trainer = Trainer(_port_model(), CFG, TC, load_templates(), device="cpu", seed=0,
                      augment="python")
    trainer.setup(steps_per_epoch=2)
    trainer.train_epoch(_dataset(5), epoch=0)
    assert [s.attrs["step"] for s in _named("train.step")] == [0, 1]
    _check_epoch(2)

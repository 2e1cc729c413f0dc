"""The trace reading and each per-layer reader, on a small Chrome trace
whose window holds K1's reduce_kernel beside PyTorch's own
at::native::reduce_kernel, N1, a convolution and a copy."""

import math
from pathlib import Path

import pytest

from perfbench import harness, tracefile
from perfbench.harness import HERE, load_module

FIXTURE = Path(__file__).parent / "fixtures" / "small_trace.json"


class FakeRun:
    def __init__(self, summary=None, e2e=None, counters=None, spans=None):
        import torch

        self.trace_summary = summary
        self.e2e = e2e or {}
        self.counters = counters or {}
        self.spans = harness.Spans(False)
        self.spans.durations.update(spans or {})
        self.devices = [torch.device("cpu")]
        self.device = self.devices[0]


def read(name, run):
    return load_module(HERE / "metrics" / f"{name}.py").read(run)


def test_kernel_names_whole():
    at = "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(at::native::ReduceOp<float>)"
    assert tracefile.kernel_base("(anonymous namespace)::reduce_kernel(float4 const*, int)") == "reduce_kernel"
    assert tracefile.kernel_base("void (anonymous namespace)::reduce_kernel<true>(float4 const*, int)") == "reduce_kernel"
    assert tracefile.kernel_base("(anonymous namespace)::nms_keep_kernel(float4 const*)") == "nms_keep_kernel"
    assert tracefile.kernel_base(at) is None
    assert not tracefile.kernel_is("void my_reduce_kernel(int)", ["reduce_kernel"])


def test_summary_of_fixture():
    s = tracefile.summarise(FIXTURE)
    assert math.isclose(s["window_s"], 1e-3)
    assert math.isclose(s["busy_s"], 825e-6)
    k1, n = tracefile.kernel_time(s, ["reduce_kernel", "unpack_kernel"])
    assert math.isclose(k1, 25e-6) and n == 2  # not the 100 us at::native::reduce_kernel
    assert [g[0] for g in s["idle_gaps"]] == ["loss_read", "idle", "train_step"]
    assert math.isclose(s["idle_gaps"][0][1], 100e-6)
    assert s["device_ops"][0][0].startswith("sm90_xmma_fprop") and math.isclose(s["device_ops"][0][1], 600e-6)


def test_trace_without_window_refused(tmp_path):
    p = tmp_path / "t.json"
    p.write_text('{"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 1}]}')
    with pytest.raises(ValueError):
        tracefile.summarise(p)


def test_readers_on_fixture():
    s = tracefile.summarise(FIXTURE)
    run = FakeRun(s, counters={"k1_bound_s_per_call": 5e-6, "n1_bound_s_per_call": 1e-6, "window_steps": 3})
    assert math.isclose(read("device_idle.train", run), 17.5)
    assert math.isclose(read("device_step_ms.train", run), 825e-3 / 3)
    assert math.isclose(read("k1_roofline", run), 100 * 5e-6 / 25e-6)
    assert math.isclose(read("n1_roofline", run), 100 * 1e-6 / 50e-6)


def test_readers_find_nothing_return_none():
    run = FakeRun()
    for name in ("device_idle.sweep", "k1_roofline", "n1_roofline", "pack_ms.sweep", "dispatch_ms.sweep",
                 "loader_wait_ms.train", "pyramid_mfu", "train_mfu", "device_step_ms.train"):
        assert read(name, run) is None, name
    # no roofline share of 0 where the kernel is absent from the trace
    s = tracefile.summarise(FIXTURE)
    s["kernels"] = {k: v for k, v in s["kernels"].items() if "nms" not in k}
    assert read("n1_roofline", FakeRun(s, counters={"n1_bound_s_per_call": 1e-6})) is None


def test_span_readers():
    run = FakeRun(spans={"pack": [0.1, 0.3], "dispatch": [0.002], "loader_next": [0.001, 0.003]})
    assert math.isclose(read("pack_ms.sweep", run), 200.0)
    assert math.isclose(read("dispatch_ms.sweep", run), 2.0)
    assert math.isclose(read("loader_wait_ms.train", run), 2.0)


def test_mfu_readers(monkeypatch):
    from perfbench.metrics import _read

    monkeypatch.setattr(_read, "device_kind", lambda run: "NVIDIA H100 80GB HBM3")
    run = FakeRun(e2e={"pyramid_img_per_s": 88.0, "train_img_per_s": 70.0},
                  counters={"flops_per_item": 1.1767e12})
    assert math.isclose(read("pyramid_mfu", run), 100 * 1.1767e12 * 88 / 989e12)
    run.counters["flops_per_item"] = 0.218e12
    assert math.isclose(read("train_mfu", run), 100 * 0.218e12 * 70 / 67e12)

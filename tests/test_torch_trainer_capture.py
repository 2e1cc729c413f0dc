"""Which route Trainer.train_step takes, on the CPU.

On a CUDA card, in one process and with nan_guard off, the Trainer's steps
are replays of one captured CUDA graph (trainer.TrainSteps): an eager
warm-up step, then a capture and its replay, then replays, and a capture
again for a new learning rate, and a new batch shape warms up eagerly
before its capture. Everywhere else the step is the eager train_step. Here
the graph is tests/test_torch_graphs.py's FakeCaptured, which runs the
plain step on the draws it is handed, so the order of the route, its
counter, its spans and its invalidation are checked on the CPU, and the
faked route is held bit-equal to eager steps.
chip_smoke.py holds the real graph to eager steps on a card. The step's
eager work and its capture run under cuDNN's timed engine search
(trainer.timed_engines), which sets `benchmark` alone and leaves the
caller's other flags as they are.
"""

import weakref

import pytest
import torch

from tests.test_torch_graphs import FakeGraph, fake_captured, install_fake_graphs  # noqa: F401
from tests.test_torch_trainer import CFG, TC, _batch, _dataset, _port_model
from tinyfaces_tpu_torch import trainer as trainer_mod
from tinyfaces_tpu_torch.config import TrainConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.parallel import distributed
from tinyfaces_tpu_torch.trainer import Trainer, replays_step
from tinyfaces_tpu_torch.utils import graphs, profiling

torch.set_num_threads(2)

EAGER = {"eager": 2, "captured": 0, "replayed": 0, "tuned": 1}


class Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("an eager route captured a graph")


@pytest.fixture
def stub(fake_captured, monkeypatch):
    """The route forced on, the graph a FakeCaptured; spans recorded."""
    monkeypatch.setattr(trainer_mod, "replays_step", lambda device, nan_guard: True)
    profiling.enable()
    profiling.reset()
    yield fake_captured
    profiling.enable(False)
    profiling.reset()


def _trainer(tc=TC, steps_per_epoch=10, **kw):
    t = Trainer(_port_model(), CFG, tc, load_templates(), device="cpu", seed=3, **kw)
    t.setup(steps_per_epoch=steps_per_epoch)
    return t


def _paths():
    return [s.attrs["path"] for s in profiling.spans() if s.name == "train.step"]


def _state(t):
    momentum = [t.opt.state[p]["momentum_buffer"] for g in t.opt.param_groups for p in g["params"]]
    return [*t.model.state_dict().values(), *momentum]


@pytest.mark.parametrize("device,nan_guard,world,want", [
    ("cuda", False, 1, True),
    ("cpu", False, 1, False),
    ("cuda", True, 1, False),
    ("cuda", False, 2, False),
])
def test_replays_step_predicate(monkeypatch, device, nan_guard, world, want):
    """A card, one process and nan_guard off, each of them needed."""
    monkeypatch.setattr(distributed, "world", lambda: world)
    assert replays_step(torch.device(device), nan_guard) is want


def _fake_world_2(monkeypatch):
    """World 2 in one process (tests/test_torch_bench.py's fake): BN's
    rows of rank 1 mirror rank 0's, the other all-reduces double."""
    def all_reduce(t, op=None):
        if t.dim() == 2 and t.shape[0] == 2:
            t[1] = t[0]
        else:
            t.mul_(2.0)

    monkeypatch.setattr(distributed, "world", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 0)
    monkeypatch.setattr(distributed.dist, "all_reduce", all_reduce)
    monkeypatch.setattr(distributed.dist, "broadcast", lambda t, src: None)


@pytest.mark.parametrize("case", ["cpu", "nan_guard", "world2"])
def test_eager_where_the_route_does_not_hold(monkeypatch, case):
    """On the CPU; and with nan_guard on or under a world of 2 where the
    device counts as a card: every step is the eager train_step, counted
    as such, its span's path `eager`, and nothing is captured."""
    monkeypatch.setattr(graphs, "Captured", Refused)
    if case != "cpu":
        real = trainer_mod.replays_step
        monkeypatch.setattr(trainer_mod, "replays_step",
                            lambda device, nan_guard: real(torch.device("cuda"), nan_guard))
    if case == "world2":
        _fake_world_2(monkeypatch)
    t = _trainer(nan_guard=case == "nan_guard")
    profiling.enable()
    profiling.reset()
    try:
        items = _dataset(4, seed=1)
        for i in range(2):
            assert torch.isfinite(t.train_step(_batch(items[2 * i:2 * i + 2])).total)
        assert t.step_counts == EAGER and t._steps.graph is None
        assert _paths() == ["eager", "eager"]
    finally:
        profiling.enable(False)
        profiling.reset()


def test_warm_up_capture_replays_and_recapture(stub, monkeypatch):
    """Step 0 eager (the warm-up), step 1 captures and replays, step 2
    replays, step 3 captures again at the staircase's next rate and
    replays, step 4 replays; every step bit-equal to an eager Trainer's
    from the same weights and seed."""
    tc = TrainConfig(batch_size=2, workers=2, lr_step_epochs=1)
    graphed = _trainer(tc, steps_per_epoch=3)
    items = _dataset(10, seed=2)
    batches = [_batch(items[2 * i:2 * i + 2]) for i in range(5)]
    got, keys = [], []
    for b in batches:
        got.append(torch.stack(list(graphed.train_step(b))))
        keys.append(graphed._steps.key)
    assert graphed.schedule(2) != graphed.schedule(3)
    assert _paths() == ["eager", "capture", "replay", "capture", "replay"]
    assert [e[0] for e in stub.events] == ["capture", "replay", "replay", "capture", "replay", "replay"]
    assert [e[1] for e in stub.events if e[0] == "capture"] == [0, 0]  # no old graph alive
    assert [k and k[0] for k in keys] == [None, graphed.schedule(1), graphed.schedule(1),
                                          graphed.schedule(3), graphed.schedule(3)]
    assert graphed.step_counts == {"eager": 1, "captured": 2, "replayed": 4, "tuned": 1}

    monkeypatch.setattr(trainer_mod, "replays_step", lambda device, nan_guard: False)
    eager = _trainer(tc, steps_per_epoch=3)
    want = [torch.stack(list(eager.train_step(b))) for b in batches]
    assert eager.step_counts == {"eager": 5, "captured": 0, "replayed": 0, "tuned": 1}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, b in zip(_state(graphed), _state(eager)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("how", ["setup", "restore"])
def test_setup_and_restore_drop_the_graph(stub, tmp_path, how):
    """After setup() (a new optimizer) or restore() (new momentum) the
    graph is gone and the next step is the eager warm-up again."""
    t = _trainer()
    items = _dataset(4, seed=4)
    for i in range(2):
        t.train_step(_batch(items[2 * i:2 * i + 2]))
    graph = weakref.ref(t._steps.graph)
    if how == "setup":
        t.setup(steps_per_epoch=10)
    else:
        path = trainer_mod.save_checkpoint(t.model, t.opt, t.step, 0, 2, save_path=tmp_path)
        t.restore(trainer_mod.load_checkpoint(path))
    assert t._steps.graph is None and graph() is None
    t.train_step(_batch(items[:2]))
    t.train_step(_batch(items[2:]))
    assert _paths() == ["eager", "capture", "eager", "capture"]
    assert t.step_counts == {"eager": 2, "captured": 2, "replayed": 2, "tuned": 2}


def test_no_reference_cycle_keeps_the_graph(stub):
    """Deleting the Trainer frees its graph at once (no cycle waits for
    the collector)."""
    t = _trainer()
    items = _dataset(4, seed=5)
    for i in range(2):
        t.train_step(_batch(items[2 * i:2 * i + 2]))
    graph = weakref.ref(t._steps.graph)
    del t
    assert graph() is None


def test_epoch_end_logs_the_replayed_steps(stub, tmp_path):
    """train_epoch's epoch_end record counts the epoch's replays: three
    steps, the first the warm-up, then 2 and 3 in the next epoch; and the
    tuned steps with their seconds: the first epoch's warm-up alone."""
    import json

    tc = TrainConfig(batch_size=2, workers=2)
    t = _trainer(tc, metrics_path=tmp_path / "m.jsonl", augment="python")
    data = _dataset(6, seed=6)
    t.train_epoch(data, 0)
    t.train_epoch(data, 1)
    t.close()
    ends = [r for r in map(json.loads, (tmp_path / "m.jsonl").read_text().splitlines())
            if r.get("event") == "epoch_end"]
    assert [r["replayed_steps"] for r in ends] == [2, 3]
    assert [r["tuned_steps"] for r in ends] == [1, 0]
    assert ends[0]["tuned_s"] == pytest.approx(t.tuned_s) and t.tuned_s > 0 and ends[1]["tuned_s"] == 0
    assert t.step_counts == {"eager": 1, "captured": 1, "replayed": 5, "tuned": 1}
    replays = [s for s in profiling.spans() if s.name == "train.step" and s.attrs["path"] == "replay"]
    assert len(replays) == 4


def test_warm_up_per_batch_shape(stub, monkeypatch):
    """A batch shape not seen since the last drop runs one eager step (the
    warm-up, cuDNN's timed search) before its capture, and the old graph is
    gone before it; shapes warmed up before only capture again, also after
    another shape's warm-up dropped their graph; setup() forgets them.
    Every step bit-equal to an eager Trainer's."""
    items = _dataset(22, seed=7)
    rows = [2, 2, 2, 3, 3, 3, 2, 2, 3]
    batches, at = [], 0
    for n in rows:
        batches.append(_batch(items[at:at + n]))
        at += n
    graphed = _trainer()
    got, alive = [], []
    for b in batches[:7]:
        got.append(torch.stack(list(graphed.train_step(b))))
        alive.append(graphed._steps.graph is not None)
    assert _paths() == ["eager", "capture", "replay", "eager", "capture", "replay", "capture"]
    assert alive == [False, True, True, False, True, True, True]  # none across a warm-up
    assert all(n == 0 for kind, n in stub.events if kind == "capture")
    assert graphed.step_counts == {"eager": 2, "captured": 3, "replayed": 5, "tuned": 2}
    assert [s.attrs["tuned"] for s in profiling.spans() if s.name == "train.step"] == [1, 0, 0, 1, 0, 0, 0]
    assert (graphed._steps.path(batches[7], graphed.schedule(graphed.step)), graphed._steps.path(
        batches[8], graphed.schedule(graphed.step))) == ("replay", "capture")
    state = [x.clone() for x in _state(graphed)]
    graphed.train_step(_batch(_dataset(4, seed=11)))  # a third shape's warm-up drops the graph
    assert graphed._steps.path(batches[7], graphed.schedule(graphed.step)) == "capture"
    graphed.setup(steps_per_epoch=10)
    assert graphed._steps.path(batches[7], graphed.schedule(0)) == "eager"

    monkeypatch.setattr(trainer_mod, "replays_step", lambda device, nan_guard: False)
    eager = _trainer()
    want = [torch.stack(list(eager.train_step(b))) for b in batches[:7]]
    assert eager.step_counts == {"eager": 7, "captured": 0, "replayed": 0, "tuned": 2}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, b in zip(state, _state(eager)):
        assert torch.equal(a, b)


def _cudnn_flags() -> dict:
    c = torch.backends.cudnn
    return {"enabled": c.enabled, "benchmark": c.benchmark, "benchmark_limit": c.benchmark_limit,
            "deterministic": c.deterministic, "allow_tf32": c.allow_tf32,
            "fp32_precision": c.fp32_precision, "conv.fp32_precision": c.conv.fp32_precision,
            "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32}


@pytest.mark.parametrize("caller", ["fp32_deterministic", "tf32"])
@pytest.mark.parametrize("route", ["eager", "warm_up", "capture"])
def test_timed_search_inside_the_step_caller_flags_kept(monkeypatch, route, caller):
    """Inside the eager step, the warm-up and the capture (the second step,
    a fake graph on the CPU: tests/test_torch_graphs.py) cuDNN's timed
    search is on, in the forward and in the backward pass, with the
    caller's TF32, determinism and `enabled` as they were; after the step
    every global flag is the caller's again."""
    fp32 = caller == "fp32_deterministic"
    seen = []
    t = _trainer()
    t.model.register_forward_pre_hook(lambda m, args: seen.append(("forward", _cudnn_flags())))
    t.model.score_res3.register_full_backward_pre_hook(
        lambda m, grad: seen.append(("backward", _cudnn_flags())))
    items = _dataset(2, seed=8)
    batch = _batch(items)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=fp32, allow_tf32=not fp32):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", not fp32)
        before = _cudnn_flags()
        if route == "capture":
            install_fake_graphs(monkeypatch)
            monkeypatch.setattr(trainer_mod, "replays_step", lambda device, nan_guard: True)
            t.train_step(batch)  # the warm-up
            seen.clear()
            assert torch.isfinite(t.train_step(batch).total)
            assert t.step_counts == {"eager": 1, "captured": 1, "replayed": 1, "tuned": 1}
            assert isinstance(t._steps.graph.graph, FakeGraph)
        else:
            if route == "warm_up":
                monkeypatch.setattr(trainer_mod, "replays_step", lambda device, nan_guard: True)
                monkeypatch.setattr(graphs, "Captured", Refused)
            assert torch.isfinite(t.train_step(batch).total)
            assert t.step_counts["tuned"] == 1
        after = _cudnn_flags()
    assert after == before and before["benchmark"] is False
    assert before["allow_tf32"] is (not fp32) and before["deterministic"] is fp32
    assert [where for where, _ in seen] == ["forward", "backward"]
    for _, inside in seen:
        assert inside == {**before, "benchmark": True}


def test_flags_restored_when_the_step_raises(monkeypatch):
    """A step that raises leaves the caller's cuDNN flags as they were."""
    t = _trainer()

    def boom(*args, **kwargs):
        assert torch.backends.cudnn.benchmark
        raise RuntimeError("boom")

    monkeypatch.setattr(trainer_mod, "detection_loss", boom)
    before = _cudnn_flags()
    with pytest.raises(RuntimeError, match="boom"):
        t.train_step(_batch(_dataset(2, seed=9)))
    assert _cudnn_flags() == before

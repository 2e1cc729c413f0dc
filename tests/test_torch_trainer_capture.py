"""Which route Trainer.train_step takes, on the CPU.

On a CUDA card, in one process and with nan_guard off, the Trainer's steps
are replays of one captured CUDA graph (trainer._CapturedSteps): an eager
warm-up step, then a capture and its replay, then replays, and a capture
again for a new learning rate. Everywhere else the step is the eager
train_step. Here the graph is a stub that runs the plain step on the draws
it is handed, so the order of the route, its counter, its spans and its
invalidation are checked on the CPU, and the stubbed route is held bit-equal
to eager steps. chip_smoke.py holds the real graph to eager steps on a card.
"""

import weakref

import pytest
import torch

from tests.test_torch_trainer import CFG, TC, _batch, _dataset, _port_model
from tinyfaces_tpu_torch import trainer as trainer_mod
from tinyfaces_tpu_torch.config import TrainConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.parallel import distributed
from tinyfaces_tpu_torch.trainer import Trainer, replays_step
from tinyfaces_tpu_torch.utils import profiling

torch.set_num_threads(2)

EAGER = {"eager": 2, "captured": 0, "replayed": 0}


class StubCaptured:
    """Stands for trainer._Captured on the CPU: its capture records the key
    and checks that no earlier graph is alive; its replay runs the plain
    step on the draws it is handed."""

    events: list = []
    made: list = []

    def __init__(self, model, opt, batch, draws, *, cfg, templates, lr):
        assert all(ref() is None for ref in StubCaptured.made), "an old graph outlived the capture"
        StubCaptured.made.append(weakref.ref(self))
        StubCaptured.events.append(("capture", lr))
        self.key = self.key_of(batch, lr)
        self.step = lambda b, d: trainer_mod.train_step(model, opt, b, None, cfg=cfg,
                                                        templates=templates, lr=lr, draws=d)

    key_of = staticmethod(trainer_mod._Captured.key_of)

    def replay(self, batch, draws):
        StubCaptured.events.append(("replay", None))
        return torch.stack(list(self.step(batch, draws)))


class Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("an eager route captured a graph")

    key_of = staticmethod(trainer_mod._Captured.key_of)


@pytest.fixture
def stub(monkeypatch):
    """The route forced on, the graph a stub; spans recorded."""
    StubCaptured.events, StubCaptured.made = [], []
    monkeypatch.setattr(trainer_mod, "replays_step", lambda device, nan_guard: True)
    monkeypatch.setattr(trainer_mod, "_Captured", StubCaptured)
    profiling.enable()
    profiling.reset()
    yield StubCaptured
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
    monkeypatch.setattr(trainer_mod, "_Captured", Refused)
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
        assert t.step_counts == EAGER and t._captured.graph is None
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
    got = [torch.stack(list(graphed.train_step(b))) for b in batches]
    assert graphed.schedule(2) != graphed.schedule(3)
    assert _paths() == ["eager", "capture", "replay", "capture", "replay"]
    assert [e[0] for e in stub.events] == ["capture", "replay", "replay", "capture", "replay", "replay"]
    assert [e[1] for e in stub.events if e[0] == "capture"] == [graphed.schedule(1), graphed.schedule(3)]
    assert graphed.step_counts == {"eager": 1, "captured": 2, "replayed": 4}

    monkeypatch.setattr(trainer_mod, "replays_step", lambda device, nan_guard: False)
    eager = _trainer(tc, steps_per_epoch=3)
    want = [torch.stack(list(eager.train_step(b))) for b in batches]
    assert eager.step_counts == {"eager": 5, "captured": 0, "replayed": 0}
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
    graph = weakref.ref(t._captured.graph)
    if how == "setup":
        t.setup(steps_per_epoch=10)
    else:
        path = trainer_mod.save_checkpoint(t.model, t.opt, t.step, 0, 2, save_path=tmp_path)
        t.restore(trainer_mod.load_checkpoint(path))
    assert t._captured.graph is None and graph() is None
    t.train_step(_batch(items[:2]))
    t.train_step(_batch(items[2:]))
    assert _paths() == ["eager", "capture", "eager", "capture"]
    assert t.step_counts == {"eager": 2, "captured": 2, "replayed": 2}


def test_no_reference_cycle_keeps_the_graph(stub):
    """Deleting the Trainer frees its graph at once (no cycle waits for
    the collector)."""
    t = _trainer()
    items = _dataset(4, seed=5)
    for i in range(2):
        t.train_step(_batch(items[2 * i:2 * i + 2]))
    graph = weakref.ref(t._captured.graph)
    del t
    assert graph() is None


def test_epoch_end_logs_the_replayed_steps(stub, tmp_path):
    """train_epoch's epoch_end record counts the epoch's replays: three
    steps, the first the warm-up, then 2 and 3 in the next epoch."""
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
    assert t.step_counts == {"eager": 1, "captured": 1, "replayed": 5}
    replays = [s for s in profiling.spans() if s.name == "train.step" and s.attrs["path"] == "replay"]
    assert len(replays) == 4

"""The port's CUDA-graph module (utils/graphs.py), on the CPU.

torch.cuda.CUDAGraph, torch.cuda.graph and is_current_stream_capturing are
faked here (`install_fake_graphs`): a capture runs its work once, eagerly,
and a replay runs nothing, so what is checked is the module's bookkeeping:
the launch counts inside and outside a capture, the static buffers and
what a replay copies into them, and the side stream off a card.
`FakeCaptured` stands for a whole `graphs.Captured` (each replay runs the
captured function eagerly on its inputs); the trainer's and the pyramid's
route tests share it (tests/test_torch_trainer_capture.py,
tests/test_torch_graph_pyramid.py). chip_smoke.py holds real graphs to
eager runs on a card.
"""

import collections
import contextlib
import sys
import threading
import weakref

import pytest
import torch

from tinyfaces_tpu_torch.utils import graphs

CPU = torch.device("cpu")


class FakeGraph:
    """torch.cuda.CUDAGraph on the CPU: the capture runs the work once; a
    replay runs nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def install_fake_graphs(monkeypatch) -> list:
    """Fake torch's graph capture on the CPU; returns the keyword arguments
    of each capture, in order."""
    captures, capturing = [], threading.local()

    @contextlib.contextmanager
    def graph(cuda_graph, **kw):
        captures.append(kw)
        capturing.on = True
        try:
            yield
        finally:
            capturing.on = False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: getattr(capturing, "on", False))
    return captures


class FakeCaptured:
    """graphs.Captured without a card: the capture runs nothing; each
    replay runs `fn` eagerly on the inputs it is handed (tensors moved to
    `device`). `events` holds ("capture", how many fakes were still alive)
    and ("replay", None), in order."""

    events: list = []
    made: list = []

    def __init__(self, fn, *inputs, device, stream=None, pool=None):
        alive = sum(ref() is not None for ref in FakeCaptured.made)
        FakeCaptured.made.append(weakref.ref(self))
        FakeCaptured.events.append(("capture", alive))
        self.fn, self.device, self.replays = fn, device, 0
        self.tally, self.capture_s = collections.Counter(), 0.0

    def replay(self, *inputs):
        self.replays += 1
        FakeCaptured.events.append(("replay", None))
        return self.fn(*(x.to(self.device) if isinstance(x, torch.Tensor) else x for x in inputs))


@pytest.fixture
def fake_captured(monkeypatch):
    """graphs.Captured replaced by FakeCaptured, its records emptied."""
    monkeypatch.setattr(FakeCaptured, "events", [])
    monkeypatch.setattr(FakeCaptured, "made", [])
    monkeypatch.setattr(graphs, "Captured", FakeCaptured)
    return FakeCaptured


def _launching(kernels):
    """A function that launches `kernels` (counts them) and returns its
    inputs' sum."""
    def fn(x, extra):
        for k in kernels:
            graphs.count_launch(k)
        return x + extra["y"][0] + extra["y"][1]
    return fn


def test_a_launch_in_a_capture_counts_in_its_tally_and_each_replay_adds_it(monkeypatch):
    install_fake_graphs(monkeypatch)
    k1, n1 = graphs.launches("k1"), graphs.launches("n1")
    x, extra = torch.ones(3), {"y": (torch.zeros(3), torch.zeros(3))}
    captured = graphs.Captured(_launching(["k1", "k1", "n1"]), x, extra, device=CPU)
    assert captured.tally == {"k1": 2, "n1": 1}
    assert (graphs.launches("k1"), graphs.launches("n1")) == (k1, n1)
    for i in range(1, 4):
        captured.replay(x, extra)
        assert (graphs.launches("k1"), graphs.launches("n1")) == (k1 + 2 * i, n1 + i)
    assert captured.graph.replays == 3


def test_launches_outside_a_capture_count_one_each_and_kernels_stay_apart(monkeypatch):
    install_fake_graphs(monkeypatch)
    k1, n1 = graphs.launches("k1"), graphs.launches("n1")
    for _ in range(3):
        graphs.count_launch("k1")
    graphs.count_launch("n1")
    assert (graphs.launches("k1"), graphs.launches("n1")) == (k1 + 3, n1 + 1)


def test_a_capture_no_captured_makes_counts_nowhere(monkeypatch):
    """A launch recorded by some other capture is neither run now nor
    replayed through this module."""
    install_fake_graphs(monkeypatch)
    k1 = graphs.launches("k1")
    with torch.cuda.graph(FakeGraph()):
        graphs.count_launch("k1")
    assert graphs.launches("k1") == k1


def test_the_inputs_are_copied_into_the_static_buffers_before_a_replay(monkeypatch):
    """The buffers are shaped as the first call's inputs (a tensor, a dict
    with a tuple inside), the capture runs on them, and each replay copies
    its inputs in before the graph runs and returns the static outputs.
    The capture takes the stream and the pool given, in thread-local
    mode."""
    captures = install_fake_graphs(monkeypatch)
    seen = []

    def fn(x, extra):
        seen.append((x, extra))
        return x * 2

    x = torch.arange(4.0)
    extra = {"y": (torch.ones(2, dtype=torch.int32), torch.zeros(1)), "z": torch.full((3,), 7.0)}
    captured = graphs.Captured(fn, x, extra, device=CPU)
    ((sx, sextra),) = seen
    assert captures == [{"pool": None, "stream": None, "capture_error_mode": "thread_local"}]
    assert sx is captured.static[0] and sx is not x and torch.equal(sx, x)
    assert sextra["y"][0].dtype == torch.int32 and sextra["z"].shape == (3,)
    order = []
    monkeypatch.setattr(captured.graph, "replay", lambda: order.append(
        (sx.clone(), sextra["y"][0].clone(), sextra["y"][1].clone(), sextra["z"].clone())))
    x2 = torch.tensor([5.0, 6.0, 7.0, 8.0])
    extra2 = {"y": (torch.full((2,), 3, dtype=torch.int32), torch.ones(1)), "z": torch.arange(3.0)}
    out = captured.replay(x2, extra2)
    assert out is captured.out and len(seen) == 1
    (got,) = order
    for g, w in zip(got, (x2, *extra2["y"], extra2["z"])):
        assert torch.equal(g, w)


def test_side_stream_off_a_card_runs_the_work_as_it_is(monkeypatch):
    """No stream is made and no pool entered off a card."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA stream or pool was used off a card")

    monkeypatch.setattr(torch.cuda, "Stream", refuse)
    monkeypatch.setattr(torch.cuda, "stream", refuse)
    monkeypatch.setattr(torch.cuda, "use_mem_pool", refuse)
    ran = []
    with graphs.side_stream(CPU):
        ran.append(torch.ones(2).sum())
    with graphs.side_stream(torch.device("meta"), stream=object(), pool=object()):
        ran.append(1)
    assert len(ran) == 2


def test_counts_from_many_threads_add_up(monkeypatch):
    """Threads counting side by side (the pyramid's dispatch threads beside
    the train loop) lose no launch."""
    install_fake_graphs(monkeypatch)
    threads, per = 16, 2000
    k1 = graphs.launches("k1")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [graphs.count_launch("k1") for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert graphs.launches("k1") == k1 + threads * per


def test_two_threads_capturing_at_once_keep_their_own_tallies(monkeypatch):
    """Each capture's tally holds its own thread's launches alone, also
    when the other thread's capture starts inside it and ends before it
    (the pyramid's submit thread beside the train step's capture)."""
    install_fake_graphs(monkeypatch)
    k1, n1 = graphs.launches("k1"), graphs.launches("n1")
    both_in, b_done = threading.Barrier(2, timeout=30), threading.Event()
    made, errors = {}, []

    def fn_a(x):
        graphs.count_launch("k1")
        both_in.wait()
        assert b_done.wait(30)
        graphs.count_launch("k1")
        return x

    def fn_b(x):
        both_in.wait()
        graphs.count_launch("n1")
        graphs.count_launch("n1")
        return x

    def capture(name, fn):
        try:
            made[name] = graphs.Captured(fn, torch.ones(1), device=CPU)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            if name == "b":
                b_done.set()

    workers = [threading.Thread(target=capture, args=a) for a in (("a", fn_a), ("b", fn_b))]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=60)
    assert not errors and not any(w.is_alive() for w in workers)
    assert made["a"].tally == {"k1": 2}
    assert made["b"].tally == {"n1": 2}
    assert (graphs.launches("k1"), graphs.launches("n1")) == (k1, n1)

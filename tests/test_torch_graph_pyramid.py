"""The compiled pyramid's contract, on the CPU (evaluation.PyramidDetector).

On a GPU each batch replays one CUDA graph per ProgramKey, the port's
counterpart of the JAX package's `jax.jit(fused_pyramid,
static_argnames=...)`. Here: the key is the JAX program's static arguments
plus batch, dtype, resample and taps; batches of one bucket share a key and
another threshold makes a new one; a key's first call runs eagerly and
its second captures (on a thread that has run eagerly), so a one-shot
caller never captures; the eager path is
chosen only off the GPU, under shard "spatial" and while tracing. And the
CUDA route makes no
host read: the whole pyramid, with N1's launch swapped for its plain
version, runs on the `meta` device, where any read of a value (`.item()`,
`bool()`, `int()`, `torch.equal`, a copy back) raises.
"""

import inspect
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.test_torch_graphs import fake_captured  # noqa: F401
from tinyfaces_tpu import evaluation as jax_eval
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.ops import nms, nms_kernel

torch.set_num_threads(2)

TINY = (1, 1, 1)
TEMPLATES = load_templates()
EC = EvalConfig(max_dets_per_scale=50, max_total_dets=50, scales=(-1, 0, 1))


def _model(dtype=None) -> TinyFacesDetector:
    return init_model(TinyFacesDetector(stage_sizes=TINY, dtype=dtype), torch.Generator().manual_seed(0))


def _images(seed: int, sizes=((100, 140), (90, 150))) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (h, w, 3), dtype=np.uint8) for h, w in sizes]


def _recording_replay(monkeypatch) -> list:
    """Route every batch to `_replay` (as on a GPU) and record its keys;
    the fake replay runs the pyramid eagerly on the replica's device."""
    keys = []

    def fake_replay(replica, key, run, images_h, meta_h):
        keys.append(key)
        return run(images_h.to(replica.device), meta_h.to(replica.device))

    monkeypatch.setattr(evaluation.PyramidDetector, "eager_reason", lambda self, device, mode: None)
    monkeypatch.setattr(evaluation.PyramidDetector, "_replay", staticmethod(fake_replay))
    return keys


def test_program_key_is_the_jax_static_arguments():
    jd = jax_eval.PyramidDetector(JaxDetector(stage_sizes=TINY), {}, TEMPLATES)
    static = [p.name for p in inspect.signature(jd._fused_pyramid).parameters.values()
              if p.kind is inspect.Parameter.KEYWORD_ONLY]
    assert static == ["scales", "h0p", "w0p", "prob_thresh", "nms_thresh", "transfer"]
    assert list(evaluation.ProgramKey._fields) == static + ["batch", "dtype", "resample", "taps"]


def test_batches_of_a_bucket_share_a_key(monkeypatch):
    keys = _recording_replay(monkeypatch)
    det = evaluation.PyramidDetector(_model(), TEMPLATES, DetectorConfig(), EC, device="cpu")
    a = det.detect_batch(_images(0), prob_thresh=0.02)
    det.detect_batch(_images(1, ((70, 130), (128, 192))), prob_thresh=0.02)  # the same 128x192 bucket
    det.detect_batch(_images(2), prob_thresh=0.02, nms_thresh=0.5)
    det.detect_batch(_images(3)[:1], prob_thresh=0.02)
    det.detect_batch(_images(4, ((150, 200), (90, 150))), prob_thresh=0.02)
    assert keys[0] == keys[1] == evaluation.ProgramKey(
        (-1, 0, 1), 128, 192, 0.02, 0.3, "rgb", 2, torch.float32, "linear", None)
    assert keys[2] == keys[0]._replace(nms_thresh=0.5)
    assert keys[3] == keys[0]._replace(batch=1)
    assert keys[4] == keys[0]._replace(h0p=192, w0p=256)
    assert len(set(keys)) == 4
    # the route itself changes nothing: the eager detector's detections
    monkeypatch.undo()
    ref = evaluation.PyramidDetector(_model(), TEMPLATES, DetectorConfig(), EC, device="cpu")
    for g, w in zip(a, ref.detect_batch(_images(0), prob_thresh=0.02)):
        np.testing.assert_array_equal(g, w)


def test_pil_keys_carry_dtype_and_taps(monkeypatch):
    keys = _recording_replay(monkeypatch)
    det = evaluation.PyramidDetector(_model(torch.bfloat16), TEMPLATES, DetectorConfig(),
                                     EvalConfig(**{**EC.__dict__, "resample": "pil"}), device="cpu")
    det.detect_batch(_images(0), prob_thresh=0.02)
    det.detect_batch(_images(0), prob_thresh=0.02)
    det.detect_batch(_images(1, ((70, 130), (128, 192))), prob_thresh=0.02)
    det.detect_batch(_images(2, ((3, 5), (128, 192))), prob_thresh=0.02)  # a 3x5 image: wider taps
    assert keys[0].resample == "pil" and keys[0].dtype == torch.bfloat16
    assert keys[0].taps == ((6, 6), (4, 4), (4, 4))
    assert keys[0] == keys[1] == keys[2]  # the same bucket and tap bounds
    assert keys[3] == keys[0]._replace(taps=((8, 12), (4, 4), (4, 4)))


class _FakeCache:
    """GraphCache's bookkeeping without a card: eager runs call `run`."""

    def __init__(self, device):
        self.device, self.graphs, self.warm, self.eager_runs = device, {}, set(), 0
        self.stream = self.pool = None
        self.threads = set()

    def eager(self, run, *args):
        self.eager_runs += 1
        self.threads.add(threading.get_ident())
        return run(*args)

    def warmed_here(self):
        return threading.get_ident() in self.threads


def _captures(fake) -> int:
    return sum(kind == "capture" for kind, _ in fake.events)


def test_a_key_is_captured_at_its_second_call(monkeypatch, fake_captured):
    """A key's first call runs eagerly (in the replica's pool), its second
    captures and replays, later ones replay; a one-shot caller never
    captures. The outputs are the eager detector's. The graph is
    tests/test_torch_graphs.py's FakeCaptured: a replay runs the pyramid
    eagerly."""
    ref = evaluation.PyramidDetector(_model(), TEMPLATES, DetectorConfig(), EC, device="cpu")
    want = ref.detect_batch(_images(0), prob_thresh=0.02)
    monkeypatch.setattr(evaluation.PyramidDetector, "eager_reason", lambda self, device, mode: None)
    det = evaluation.PyramidDetector(_model(), TEMPLATES, DetectorConfig(), EC, device="cpu")
    cache = _FakeCache(det.replicas[0].device)
    det.replicas[0] = det.replicas[0]._replace(cache=cache)
    got = []
    for i in range(3):
        got.append(det.detect_batch(_images(0), prob_thresh=0.02))
        assert (cache.eager_runs, _captures(fake_captured), len(cache.graphs)) == (1, min(i, 1), min(i, 1))
        assert len(cache.warm) == (1 if i == 0 else 0)
    (prog,) = cache.graphs.values()
    assert prog.replays == 2
    det.detect_batch(_images(0), prob_thresh=0.02, nms_thresh=0.5)  # a new key: eager again
    assert (cache.eager_runs, _captures(fake_captured), len(cache.warm)) == (2, 1, 1)
    # the new key's second call on a thread that never ran eagerly: eager
    # there first (its cuDNN and cuBLAS handles), then that thread captures
    with ThreadPoolExecutor(1) as pool:
        for runs, captures in ((3, 1), (3, 2)):
            pool.submit(det.detect_batch, _images(0), prob_thresh=0.02, nms_thresh=0.5).result()
            assert (cache.eager_runs, _captures(fake_captured)) == (runs, captures)
    for g in got:
        for a, b in zip(g, want):
            np.testing.assert_array_equal(a, b)


def test_out_of_memory_releases_the_pool_once(monkeypatch):
    """GraphCache.eager: out of memory in the pool releases the graphs and
    the pool and runs once more; out of memory again raises."""
    cache = evaluation.GraphCache.__new__(evaluation.GraphCache)
    cache.releases, cache._thread, events = 0, threading.local(), []
    monkeypatch.setattr(cache, "release", lambda: events.append("release"), raising=False)
    fail = [True]

    def pooled(run, *args):
        events.append("run")
        if fail.pop(0):
            raise torch.cuda.OutOfMemoryError("pool full")
        return run(*args)

    monkeypatch.setattr(cache, "_pooled", pooled, raising=False)
    fail[:] = [True, False]
    assert not cache.warmed_here()
    assert cache.eager(lambda x: x + 1, 1) == 2
    assert events == ["run", "release", "run"] and cache.releases == 1 and cache.warmed_here()
    fail[:] = [False]
    assert cache.eager(lambda x: x * 3, 2) == 6 and cache.releases == 1
    fail[:] = [True, True]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        cache.eager(lambda x: x, 0)
    assert cache.releases == 2


def test_eager_only_off_the_gpu_under_spatial_and_trace(monkeypatch):
    det = evaluation.PyramidDetector(_model(), TEMPLATES, DetectorConfig(), EC, device="cpu")
    cuda = torch.device("cuda", 0)
    assert det.eager_reason(torch.device("cpu"), "batch") == "not a GPU"
    assert det.eager_reason(torch.device("meta"), "batch") == "not a GPU"
    assert det.eager_reason(cuda, "batch") is None
    assert det.eager_reason(cuda, "spatial") == "shard spatial"
    det.trace = []
    assert det.eager_reason(cuda, "batch") == "trace"
    det.trace = None
    # on the CPU every batch runs eagerly: _replay is never reached
    monkeypatch.setattr(evaluation.PyramidDetector, "_replay",
                        staticmethod(lambda *a: pytest.fail("replayed on the CPU")))
    det.detect_batch(_images(0), prob_thresh=0.02)
    spatial = evaluation.PyramidDetector(_model(), TEMPLATES, DetectorConfig(), EC,
                                         device=["cpu", "cpu"], shard="spatial")
    spatial.detect_batch(_images(0)[:1], prob_thresh=0.02)


def test_nms_cuda_route_makes_no_host_read(monkeypatch):
    """nms() and batched_nms_padded() off the CPU go to N1's wrapper and
    read nothing back: on `meta` tensors they give the shapes."""
    calls = []

    def plain_launch(boxes, valid, thr):
        calls.append(boxes.device.type)
        return nms_kernel.nms_blocked_reference(boxes, valid, thr)

    monkeypatch.setattr(nms_kernel, "_launch", plain_launch)
    b, n = 3, 200
    boxes = torch.empty(b, n, 4, device="meta")
    scores = torch.empty(b, n, device="meta")
    valid = torch.empty(b, n, dtype=torch.bool, device="meta")
    order, keep = nms.nms(boxes, scores, 0.3, valid)
    assert order.shape == keep.shape == (b, n) and keep.dtype == torch.bool
    out_b, out_s, out_v = nms.batched_nms_padded(boxes, scores, 0.3, valid, 50)
    assert out_b.shape == (b, 50, 4) and out_s.shape == out_v.shape == (b, 50)
    assert calls == ["meta", "meta"]
    with pytest.raises(RuntimeError):  # meta tensors do refuse a host read
        int(valid.sum())


@pytest.mark.parametrize("transfer,resample", [
    ("rgb", "linear"), ("yuv420", "linear"), ("jpegdct", "linear"), ("jpegdct4", "linear"),
    ("rgb", "pil"),
])
def test_fused_pyramid_makes_no_host_read(transfer, resample, monkeypatch):
    """The whole pyramid on `meta`: the wire's unpack, the resize (or the
    folded stem, or the PIL resize with the host's taps), the forwards, the
    decode and N1 (its plain version), for a batch of two images."""
    calls = []

    def plain_launch(boxes, valid, thr):
        calls.append(tuple(boxes.shape))
        return nms_kernel.nms_blocked_reference(boxes, valid, thr)

    monkeypatch.setattr(nms_kernel, "_launch", plain_launch)
    ec = EvalConfig(**{**EC.__dict__, "resample": resample})
    det = evaluation.PyramidDetector(_model().to("meta"), TEMPLATES, DetectorConfig(), ec,
                                     device="meta", transfer=transfer)
    packed = det.pack_inputs(_images(0))
    out = det.detect_batch_async(packed, prob_thresh=0.02)
    assert out.host.device.type == "meta" and out.host.shape == (2, EC.max_total_dets, 6)
    assert calls == [(2, len(EC.scales) * EC.max_dets_per_scale, 4)]

"""The port's DetectionService: results equal detect_batch for the same
images, with requests of two canvas buckets submitted from several threads
(the dispatcher coalesces them into batches of its own choosing, so each
result is compared at the composition tolerances of
tests/test_torch_evaluation.py)."""

import threading

import numpy as np
import torch

from tinyfaces_tpu.config import DetectorConfig, EvalConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.evaluation import PyramidDetector
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.serving import DetectionService

torch.set_num_threads(2)


def _detector():
    model = init_model(TinyFacesDetector(stage_sizes=(1, 1, 1)), torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.score_res3.bias[:25] -= 2.0
    ec = EvalConfig(scales=(-1, 0), max_dets_per_scale=50, max_total_dets=50)
    return PyramidDetector(model, load_templates(), DetectorConfig(), ec, device="cpu")


def test_service_matches_detect_batch_across_threads():
    det = _detector()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 255, (96, 120, 3) if i % 2 else (150, 200, 3), dtype=np.uint8)
            for i in range(12)]
    want = [det.detect_batch([im], prob_thresh=0.05)[0] for im in imgs]
    assert sum(w.shape[0] for w in want) > 20

    svc = DetectionService(det, max_batch=4, max_delay_ms=20, prob_thresh=0.05)
    futures = [None] * len(imgs)

    def client(t):
        for i in range(t, len(imgs), 4):
            futures[i] = svc.submit(imgs[i])

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        got = [f.result(timeout=120) for f in futures]
    finally:
        svc.close()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-2, rtol=0)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-3, rtol=0)

"""The reference's redo of the train loader's input (reference/augment.py)
equals the port's C++ engine value for value, and its generator is the
C++ standard's."""

import numpy as np
import pytest

from perfbench.reference import augment as A


def test_mt19937_64_is_the_standards():
    g = A.MT19937_64(5489)
    for _ in range(9999):
        g()
    assert g() == 9981545732273789042  # the C++ standard's required 10000th value


@pytest.mark.parametrize("case", range(4))
def test_augment_equals_the_engine(case):
    from tinyfaces_tpu_torch.data import native

    rng = np.random.default_rng(case)
    for k in range(15):
        h, w = int(rng.integers(120, 700)), int(rng.integers(120, 700))
        if k == 0:
            h = 1  # too small to halve
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        n = int(rng.integers(0, 40))
        x1, y1 = np.floor(rng.uniform(0, w, n)), np.floor(rng.uniform(0, h, n))
        bw, bh = np.floor(rng.uniform(1, 80, n)), np.floor(rng.uniform(1, 80, n))
        boxes = np.stack([x1, y1, x1 + bw - 1, y1 + bh - 1], 1).astype(np.float32)
        seed = int(rng.integers(0, 2**62)) + k * 0x9E3779B9
        port = native.native_augment_sample(img, boxes, (256, 224), 0.3, 24, seed)
        ref = A.augment(img, boxes, (256, 224), 0.3, 24, seed)
        for key in port:
            assert np.array_equal(np.asarray(port[key]), np.asarray(ref[key])), (k, key)


def test_batches_equal_the_loader(tmp_path):
    import torch

    from perfbench.drivers._shared import rng
    from perfbench.traffic import generate
    from tinyfaces_tpu_torch.config import DetectorConfig
    from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader
    from tinyfaces_tpu_torch.data.wider_face import WIDERFace

    t = {"images": 3, "width": 320, "height": [240, 320], "repeats": 4, "quality": 90,
         "faces_scale": 4.0, "faces_alpha": 1.2, "face_median_px": 24, "face_sigma": 0.6, "face_px": [8, 60]}
    ann, _ = generate.wider_tree(rng(9, 5), tmp_path, t)
    cfg = DetectorConfig(input_size=(128, 128), max_gt=24)
    seed = 2**62 + 17
    loader = NativePrefetchLoader(WIDERFace(ann, np.ones((25, 4)), cfg=cfg, dataset_root=tmp_path, split="train"),
                                  2, device=torch.device("cpu"), workers=2, seed=seed, epoch=0, pack="rgb")
    program = [b for _, b in zip(range(3), loader)]
    ref = A.batches(tmp_path, ann, seed, 2, 3, (128, 128), cfg.neg_thresh, 24)
    assert A.aug_diff(program, ref) == 0
    program[1]["image"][0, 5, 5, 0] ^= 1
    assert A.aug_diff(program, ref) == 1

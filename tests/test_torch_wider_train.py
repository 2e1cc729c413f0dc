"""The port's WIDER train data against the JAX package's on the CPU.

The Python augmentation (`augment_draws`, `augment_sample`,
`crop_and_paste`) from the same numpy generator gives bit-identical
outputs, covering x0.5 / x1 / x2 resizes, crops without boxes and crops
with more than `max_gt` boxes, and the GT-overflow counters agree. The
train `WIDERFace` over a small JPEG tree yields the JAX dataset's samples
for two (seed, epoch) pairs.
"""

import contextlib

import numpy as np
import pytest

from tinyfaces_tpu.config import DetectorConfig as JaxDetectorConfig
from tinyfaces_tpu.data import overflow as jax_overflow
from tinyfaces_tpu.data import wider_face as jax_wf
from tinyfaces_tpu_torch.config import DetectorConfig
from tinyfaces_tpu_torch.data import get_dataloader, load_templates, overflow
from tinyfaces_tpu_torch.data import wider_face as wf

CFG = DetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=8)
JAX_CFG = JaxDetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=8)
TREE_SIZES = [(180, 240), (240, 160), (150, 150), (200, 260), (120, 300)]
TREE_FACES = [3, 0, 14, 5, 2]


def random_boxes(rng, h, w, n, lo=4, hi=60):
    """n corner boxes inside an h x w image, float64 as parsed."""
    bw, bh = rng.uniform(lo, min(hi, w - 1), n), rng.uniform(lo, min(hi, h - 1), n)
    x1, y1 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    return np.stack([x1, y1, x1 + bw, y1 + bh], 1)


def write_train_tree(root, sizes=TREE_SIZES, faces=TREE_FACES, seed=0):
    """A WIDER train tree of JPEGs (root/WIDER_train/images/...) and its
    annotation file (root/train.txt); returns the annotation path."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    lines = []
    for i, ((h, w), n) in enumerate(zip(sizes, faces)):
        rel = f"{i % 2}--Event{i % 2}/img_{i}.jpg"
        path = root / "WIDER_train" / "images" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path, quality=90)
        boxes = np.round(random_boxes(rng, h, w, n, lo=8, hi=50))
        lines += [rel, str(n)]
        lines += [f"{int(x1)} {int(y1)} {int(x2 - x1)} {int(y2 - y1)} 0 0 0 0 0 0"
                  for x1, y1, x2, y2 in boxes] or ["0 0 0 0 0 0 0 0 0 0"]
    ann = root / "train.txt"
    ann.write_text("\n".join(lines) + "\n")
    return ann


def _case(kind, rng):
    h, w = (int(rng.integers(20, 60)), int(rng.integers(20, 60))) if kind == "small image" else \
        (int(rng.integers(60, 320)), int(rng.integers(60, 320)))
    n = {"no boxes": 0, "few boxes": int(rng.integers(1, 7)), "over max_gt": int(rng.integers(20, 40)),
         "small image": int(rng.integers(0, 4))}[kind]
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return img, random_boxes(rng, h, w, n, hi=min(h, w) - 2)


def _equal(a, b):
    assert type(a) is type(b) or (np.ndim(a) and np.ndim(b))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("kind", ["no boxes", "few boxes", "over max_gt", "small image"])
def test_augmentation_is_bit_identical_to_jax(kind):
    overflow.reset()
    jax_overflow.reset()
    scales = set()
    with pytest.warns(RuntimeWarning, match="GT truncation") if kind == "over max_gt" else \
            contextlib.nullcontext():
        for seed in range(30):
            img, boxes = _case(kind, np.random.default_rng((seed, len(kind))))
            draws, *rest = wf.augment_draws(img.shape[:2], boxes.copy(), CFG,
                                            np.random.default_rng(seed))
            jdraws, *jrest = jax_wf.augment_draws(img.shape[:2], boxes.copy(), JAX_CFG,
                                                  np.random.default_rng(seed))
            assert tuple(draws) == tuple(jdraws)
            scales.add(draws.scale_id)
            for a, b in zip(rest, jrest):
                _equal(a, b)
            got = wf.augment_sample(img, boxes.copy(), CFG, np.random.default_rng(seed))
            want = jax_wf.augment_sample(img, boxes.copy(), JAX_CFG, np.random.default_rng(seed))
            for a, b in zip(got, want):
                _equal(a, b)
            got = wf.crop_and_paste(img, boxes.copy(), CFG.input_size, CFG.neg_thresh,
                                    np.random.default_rng(seed))
            want = jax_wf.crop_and_paste(img, boxes.copy(), JAX_CFG.input_size,
                                         JAX_CFG.neg_thresh, np.random.default_rng(seed))
            for a, b in zip(got, want):
                _equal(a, b)
    assert scales == {0, 1, 2}
    assert overflow.snapshot() == jax_overflow.snapshot()
    assert (overflow.snapshot()["dropped_boxes"] > 0) == (kind == "over max_gt")


@pytest.mark.parametrize("seed,epoch", [(0, 0), (7, 3)])
def test_train_dataset_matches_jax(tmp_path, seed, epoch):
    ann = write_train_tree(tmp_path)
    templates = load_templates()
    ours = wf.WIDERFace(ann, templates, cfg=CFG, dataset_root=tmp_path, split="train", seed=seed)
    theirs = jax_wf.WIDERFace(ann, templates, cfg=JAX_CFG, dataset_root=tmp_path, split="train",
                              seed=seed)
    ours.set_epoch(epoch)
    theirs.set_epoch(epoch)
    assert len(ours) == len(theirs) == len(TREE_SIZES)
    np.testing.assert_array_equal(ours.get_all_bboxes(), theirs.get_all_bboxes())
    overflow.reset()
    jax_overflow.reset()
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got.keys() == want.keys()
        for k in got:
            _equal(got[k], want[k])
    assert overflow.snapshot() == jax_overflow.snapshot()


def test_factory_and_unported_wires(tmp_path):
    ann = write_train_tree(tmp_path)

    class Args:
        dataset_root = str(tmp_path)

    dataset, templates = get_dataloader(ann, Args(), cfg=CFG, train=True, split="train")
    assert dataset.split == "train" and dataset.cfg == CFG and templates.shape == (25, 5)
    item = dataset[2]
    assert item["image"].shape == (128, 128, 3) and item["gt_boxes"].shape == (8, 4)
    with pytest.raises(NotImplementedError, match="item 10"):
        dataset.get_dct(0)
    with pytest.raises(NotImplementedError, match="item 11"):
        dataset.getitem_train_dct(0)

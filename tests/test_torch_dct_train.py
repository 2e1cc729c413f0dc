"""The port's `jpegdct` train wire (data/dct_train.py and the device half
in data/targets.py) against the JAX package's on the CPU.

From the same seed the train items are equal (the wire bytes and every
geometry key); region_anchor and upsample_src are equal; the device
augmentation agrees within 1e-5 in normalized units on the three scale
branches (tests/test_dct_train.py's cases, both flips) and build_targets
gives equal class maps. The loaders, one train step and the CLI on this
wire are in tests/test_torch_dct_train_loop.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dct_train import _jpeg_roundtrip, _seeds_per_scale, _smooth_image
from tests.test_torch_native import _assert_same, jax_native_library  # noqa: F401
from tests.test_torch_wider_train import CFG, JAX_CFG
from tinyfaces_tpu.config import DetectorConfig as JaxDetectorConfig
from tinyfaces_tpu.data import dct_train as jax_dct
from tinyfaces_tpu.data import wider_face as jax_wf
from tinyfaces_tpu.data.targets import build_targets as jax_build_targets
from tinyfaces_tpu.data.targets import device_augment_dct as jax_augment
from tinyfaces_tpu_torch.config import DetectorConfig
from tinyfaces_tpu_torch.data import dct_train, load_templates
from tinyfaces_tpu_torch.data import wider_face as wf
from tinyfaces_tpu_torch.data.targets import build_targets, device_augment_dct

torch.set_num_threads(2)

BOXES = np.array([[50, 50, 200, 220]], np.float32)


def _image():
    data, _ = _jpeg_roundtrip(_smooth_image(np.random.default_rng(7), 560, 730))
    return data


def _items(cfg, jax_cfg, data, seeds, boxes=BOXES):
    ours_d, theirs_d = dct_train.decode_dct(data), jax_dct.decode_dct(data)
    ours = [dct_train.train_item_dct(ours_d, boxes.copy(), cfg, np.random.default_rng(s)) for s in seeds]
    theirs = [jax_dct.train_item_dct(theirs_d, boxes.copy(), jax_cfg, np.random.default_rng(s))
              for s in seeds]
    return ours, theirs


def _stack(items):
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _scale_and_flip_seeds(hw, cfg):
    """Seeds covering each scale branch with either flip."""
    seeds = []
    for flip in (False, True):
        found = {}
        for seed in range(400):
            d, *_ = jax_wf.augment_draws(hw, BOXES.copy(), cfg, np.random.default_rng(seed))
            if d.flip == flip:
                found.setdefault(d.scale_id, seed)
        seeds += [found[s] for s in (0, 1, 2)]
    return seeds


def test_region_anchor_and_upsample_src_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        hw = (int(rng.integers(40, 1400)), int(rng.integers(40, 1400)))
        seed = int(rng.integers(1 << 31))
        ours, *_ = wf.augment_draws(hw, BOXES.copy(), DetectorConfig(), np.random.default_rng(seed))
        theirs, *_ = jax_wf.augment_draws(hw, BOXES.copy(), JaxDetectorConfig(),
                                          np.random.default_rng(seed))
        assert tuple(ours) == tuple(theirs)
        assert dct_train.region_anchor(ours) == jax_dct.region_anchor(theirs)
    for n in (128, 500, 501, 640):
        assert dct_train.upsample_src(n) == jax_dct.upsample_src(n)
    assert dct_train.TRAIN_REGION == jax_dct.TRAIN_REGION
    assert dct_train.wire_total_bytes() == jax_dct.wire_total_bytes() == 713992


@pytest.mark.parametrize("source", ["color", "gray", "small"])
def test_train_items_equal_jax(source):
    if source == "color":
        data = _image()
    else:
        from tests.test_jpegdct import encode, natural_image

        h, w = (300, 410) if source == "gray" else (90, 70)
        img = natural_image(h, w, seed=4, color=source != "gray")
        data = encode(img[..., 0] if source == "gray" else img, quality=90)
    seeds = list(range(12))
    ours, theirs = _items(DetectorConfig(), JaxDetectorConfig(), data, seeds)
    scales = set()
    for a, b in zip(ours, theirs):
        _assert_same(a, b)
        scales.add(int(a["aug_scale"]))
    assert scales == {0, 1, 2}


def test_device_augment_matches_jax_on_every_branch():
    data = _image()
    cfg, jax_cfg = DetectorConfig(), JaxDetectorConfig()
    seeds = _scale_and_flip_seeds((560, 730), jax_cfg)
    assert set(_seeds_per_scale((560, 730), jax_cfg)) == {0, 1, 2}
    ours, theirs = _items(cfg, jax_cfg, data, seeds)
    batch = _stack(theirs)
    assert sorted(batch["aug_scale"].tolist()) == [0, 0, 1, 1, 2, 2] and batch["flip"].sum() == 3
    want = np.asarray(jax_augment(batch, jax_cfg))
    got = device_augment_dct({k: torch.from_numpy(v) for k, v in _stack(ours).items()}, cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (6, 500, 500, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_build_targets_on_the_dct_wire_matches_jax():
    templates = load_templates()
    faces = np.array([[x, y, x + 24, y + 28] for x in range(8, 700, 40) for y in range(8, 520, 48)],
                     np.float32)
    ours, theirs = _items(CFG, JAX_CFG, _image(), [1, 2, 3], boxes=faces)
    key = jax.random.PRNGKey(8)
    imgs_w, cls_w, reg_w = jax_build_targets({k: jnp.asarray(v) for k, v in _stack(theirs).items()},
                                             jnp.asarray(templates, jnp.float32), key, JAX_CFG)
    vsy, vsx = CFG.heatmap_size
    noise = np.stack([np.asarray(1e-6 * jax.random.uniform(k, (vsy, vsx, 25, CFG.max_gt)))
                      for k in jax.random.split(key, 3)])
    imgs, cls, reg = build_targets({k: torch.from_numpy(v) for k, v in _stack(ours).items()},
                                   torch.tensor(templates), None, CFG, noise_tensor=torch.from_numpy(noise))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(imgs_w), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(cls_w))
    np.testing.assert_allclose(reg.numpy(), np.asarray(reg_w), atol=1e-5, rtol=0)
    assert (cls.numpy() == 1).any()

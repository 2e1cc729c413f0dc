"""The seeded generators give the same traffic for the same seed, the same
set of sizes, counts and gaps for every seed, and the shapes the mixes
promise."""

import numpy as np

from perfbench.drivers._shared import rng
from perfbench.reference.pyramid import bucket
from perfbench.tests.tiny import decode_jpeg
from perfbench.run import load_cell
from perfbench.traffic import generate


def test_images_deterministic_and_in_one_bucket():
    _, _, _, t = load_cell("eval-sweep-b32", unlisted=True)
    sizes = generate.image_sizes(rng(11, 1), t["pool"], t["height"], t["width"])
    again = generate.image_sizes(rng(11, 1), t["pool"], t["height"], t["width"])
    other = generate.image_sizes(rng(12, 1), t["pool"], t["height"], t["width"])
    assert sizes == again
    assert sizes != other
    assert sorted(h for h, _ in sizes) == sorted(h for h, _ in other)
    assert {(bucket(h), bucket(w)) for h, w in sizes} == {(768, 1024)}
    assert (min(h for h, _ in sizes), max(h for h, _ in sizes)) == tuple(t["height"])
    assert (min(w for _, w in sizes), max(w for _, w in sizes)) == tuple(t["width"])


def test_jpeg_pool_deterministic():
    a = generate.jpeg_pool(rng(5, 1), 3, [96, 128], [160, 192], 90)
    b = generate.jpeg_pool(rng(5, 1), 3, [96, 128], [160, 192], 90)
    assert [x[0] for x in a] == [x[0] for x in b]
    im = decode_jpeg(a[0][0])
    assert im.dtype == np.uint8 and im.shape[2] == 3 and im.shape[0] % 16 == 0


def test_poisson_schedule():
    for seed in (1, 2**31 + 7):
        t = generate.arrivals(rng(seed, 3), 60.0, 20.0)
        assert np.array_equal(t, generate.arrivals(rng(seed, 3), 60.0, 20.0))
        assert len(t) == 1200 and t[0] == 0.0 and t[-1] < 20.0 and np.all(np.diff(t) > 0)
    g1 = np.sort(np.diff(generate.arrivals(rng(1, 3), 60.0, 20.0)))
    g2 = np.sort(np.diff(generate.arrivals(rng(2, 3), 60.0, 20.0)))
    assert abs(g1.mean() - 1 / 60) < 1e-3 and abs(g1.sum() - g2.sum()) < 0.2


def test_wider_tree(tmp_path):
    _, _, _, t = load_cell("train-wider-b12")
    small = dict(t, images=12, repeats=2)
    ann, summary = generate.wider_tree(rng(3, 5), tmp_path / "a", small)
    ann2, _ = generate.wider_tree(rng(3, 5), tmp_path / "b", small)
    assert ann.read_text() == ann2.read_text()
    files = sorted((tmp_path / "a").rglob("*.jpg"))
    assert len(files) == 12 and summary["entries"] == 24
    assert [f.read_bytes() for f in files] == [f.read_bytes() for f in sorted((tmp_path / "b").rglob("*.jpg"))]
    counts = generate.face_counts(t["images"], t["faces_scale"], t["faces_alpha"])
    assert np.median(counts) < 20 and counts.max() > 192  # a tail past max_gt
    im = decode_jpeg(files[0].read_bytes())
    assert im.shape[1] == t["width"] and t["height"][0] <= im.shape[0] <= t["height"][1]

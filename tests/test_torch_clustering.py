"""The port's template clustering (tinyfaces_tpu_torch.clustering,
tools/cluster_templates.py, load_templates' re-clustering) against the JAX
package's on the CPU.

Both are host NumPy with the same draws from np.random.default_rng(seed),
so every medoid set must be equal — on the cases of
tests/test_clustering.py, with every backend name.
"""

import json
import sys

import numpy as np
import pytest

import tinyfaces_tpu.clustering.cluster as jax_cluster
import tinyfaces_tpu.data as jax_data
from tinyfaces_tpu_torch import data as port_data
from tinyfaces_tpu_torch.clustering import cluster
from tinyfaces_tpu_torch.tools import cluster_templates

BACKENDS = ("local", "pam", "pyclustering", "pyclust")


def _case(name):
    """tests/test_clustering.py's inputs: corner boxes for compute_kmedoids."""
    if name == "separated":  # test_kmedoids_recovers_separated_clusters
        rng = np.random.default_rng(1)
        pts = []
        for s in (8.0, 40.0, 200.0):
            w = s * rng.uniform(0.95, 1.05, 30)
            h = s * rng.uniform(0.95, 1.05, 30)
            pts.append(np.stack([-w / 2, -h / 2, w / 2, h / 2], axis=1))
        return np.concatenate(pts), 3, 3
    if name == "layout":  # test_compute_kmedoids_return_layout
        rng = np.random.default_rng(2)
        n = 80
        return np.stack([rng.uniform(0, 10, n), rng.uniform(0, 10, n),
                         rng.uniform(20, 200, n), rng.uniform(20, 200, n)], axis=1), 5, 5
    if name == "pam":  # test_pam_backend_beats_or_matches_local
        rng = np.random.default_rng(0)
        sizes = np.concatenate([rng.normal(20, 1.5, (60, 2)), rng.normal(60, 3.0, (60, 2)),
                                rng.normal(140, 6.0, (60, 2))])
        return np.stack([-(sizes[:, 0] - 1) / 2, -(sizes[:, 1] - 1) / 2,
                         (sizes[:, 0] - 1) / 2, (sizes[:, 1] - 1) / 2], 1), 3, 3
    # test_reference_backend_names_map_to_pam
    rng = np.random.default_rng(1)
    s = rng.uniform(10, 100, (40, 2))
    return np.stack([np.zeros(40), np.zeros(40), s[:, 0], s[:, 1]], 1), 3, 4


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", ["separated", "layout", "pam", "names"])
def test_medoids_equal_jax(case, backend):
    boxes, lo, hi = _case(case)
    kw = dict(option=backend, indices=lo, max_clusters=hi, seed=0)
    got = cluster.compute_kmedoids(boxes, 1, **kw)
    want = jax_cluster.compute_kmedoids(boxes, 1, **kw)
    assert len(got) == len(want) == hi + 1
    assert got[:lo] == want[:lo] == [{}] * lo
    for g, w in zip(got[lo:], want[lo:]):
        assert g["n_clusters"] == w["n_clusters"] and g["class"] == w["class"] == 1
        np.testing.assert_array_equal(g["medoids"], w["medoids"])


def test_primitives_equal_jax_and_cache(tmp_path):
    boxes, _, _ = _case("layout")
    centred = cluster.centralize_bbox(boxes)
    np.testing.assert_array_equal(centred, jax_cluster.centralize_bbox(boxes))
    np.testing.assert_allclose(cluster.centralize_bbox(np.array([[10.0, 20.0, 19.0, 39.0]])),
                               [[-4.5, -9.5, 4.5, 9.5]])
    dist = cluster.compute_distances(centred)
    np.testing.assert_array_equal(dist, jax_cluster.compute_distances(centred))
    medoids, assign = cluster.k_medoids(dist, 4, np.random.default_rng(0))
    want = jax_cluster.k_medoids(dist, 4, np.random.default_rng(0))
    np.testing.assert_array_equal(medoids, want[0])
    np.testing.assert_array_equal(assign, want[1])
    with pytest.raises(ValueError):
        cluster.k_medoids(np.zeros((3, 3)), 5, np.random.default_rng(0))
    with pytest.raises(ValueError, match="unknown clustering backend"):
        cluster.compute_kmedoids(boxes, 1, option="sklearn", indices=3, max_clusters=3)
    # max_limit subsampling draws from the same stream; the .npy cache is reused
    first = cluster.compute_kmedoids(boxes, 2, indices=3, max_clusters=3, max_limit=50,
                                     cache_dir=tmp_path)
    assert (tmp_path / "distances_2.npy").is_file()
    again = cluster.compute_kmedoids(boxes, 2, indices=3, max_clusters=3, max_limit=50,
                                     cache_dir=tmp_path)
    want = jax_cluster.compute_kmedoids(boxes, 2, indices=3, max_clusters=3, max_limit=50)
    np.testing.assert_array_equal(first[3]["medoids"], want[3]["medoids"])
    np.testing.assert_array_equal(again[3]["medoids"], want[3]["medoids"])


def _annotations(tmp_path, n_images=3, faces=30):
    rng = np.random.default_rng(3)
    lines = []
    for i in range(n_images):
        rows = []
        for _ in range(faces):
            w, h = int(rng.integers(10, 120)), int(rng.integers(10, 120))
            rows.append(f"{rng.integers(0, 200)} {rng.integers(0, 200)} {w} {h} 0 0 0 0 0 0")
        lines += [f"0--Ev/im{i}.jpg", str(len(rows))] + rows
    ann = tmp_path / "gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    return ann


def test_load_templates_reclusters_a_missing_file(tmp_path):
    ann = _annotations(tmp_path)
    with pytest.raises(FileNotFoundError, match="no traindata"):
        port_data.load_templates(tmp_path / "missing.json")
    got = port_data.load_templates(tmp_path / "port.json", ann, 25)
    want = jax_data.load_templates(tmp_path / "jax.json", ann, 25)
    assert got.shape == (25, 4)  # the JAX package's layout: no natural-scale column
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    np.testing.assert_array_equal(port_data.load_templates(tmp_path / "port.json"), got)

    class Args:
        traindata = ann
        dataset_root = ""

    _, templates = port_data.get_dataloader(ann, Args(), 10, template_file=tmp_path / "ten.json",
                                            train=True, split="train")
    assert templates.shape == (10, 4)


@pytest.mark.parametrize("option", ["local", "pam"])
def test_cluster_cli_equals_jax(tmp_path, monkeypatch, option):
    import tools.cluster_templates as jax_cli

    ann = _annotations(tmp_path)
    flags = ["--num-templates", "10", "--option", option, "--seed", "1"]
    cluster_templates.main([str(ann), *flags, "--out", str(tmp_path / "port.json")])
    monkeypatch.setattr(sys, "argv", ["cluster_templates.py", str(ann), *flags,
                                      "--out", str(tmp_path / "jax.json")])
    jax_cli.main()
    templates = np.asarray(json.loads((tmp_path / "port.json").read_text()))
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert templates.shape == (10, 5)
    np.testing.assert_allclose(templates[:, 0], -templates[:, 2])
    np.testing.assert_allclose(templates[:, 4], 1.0)
    areas = (templates[:, 2] - templates[:, 0]) * (templates[:, 3] - templates[:, 1])
    assert (np.diff(areas) <= 1e-9).all()


def test_cluster_cli_writes_the_ports_file_by_default():
    args = cluster_templates.arguments(["gt.txt"])
    assert args.out == str(port_data.TEMPLATE_FILE) and "tinyfaces_tpu_torch" in args.out
    assert (args.num_templates, args.max_limit, args.seed, args.option) == (25, 5000, 0, "local")

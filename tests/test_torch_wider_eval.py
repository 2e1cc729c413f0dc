"""The port's grader and metrics (tinyfaces_tpu_torch.{wider_eval,metrics})
against the root wider_eval.py and tinyfaces_tpu.metrics on the CPU.

The fixtures are those of tests/test_wider_eval.py (its hand-made cases and
its 6 seeded random fixtures): every AP must be equal to the root grader's,
and within 1e-6 of the loop-level transcription of the official eval_tools
(tests/wider_eval_official.py). voc_ap, average_precision and
compute_model_score are plain NumPy on both sides: equal. rect_dist and
jaccard_index are jnp (float32) in the JAX package and float64 here:
within 1e-6.
"""

import json
import sys

import numpy as np
import pytest

import wider_eval as root_eval
from tests.test_wider_eval import _random_fixture
from tests.wider_eval_official import evaluate_official
from tinyfaces_tpu import metrics as jax_metrics
from tinyfaces_tpu.evaluation import write_results as jax_write_results
from tinyfaces_tpu_torch import metrics, wider_eval
from tinyfaces_tpu_torch.evaluation import write_results

# tests/test_wider_eval.py's hand-made cases: (results, gt, keep)
_HAND = {
    "perfect": ({"e/a.jpg": np.array([[10, 10, 20, 20, 2.0]]),
                 "e/b.jpg": np.array([[5, 5, 12, 12, 1.0]])},
                {"e/a.jpg": np.array([[10.0, 10, 20, 20]]), "e/b.jpg": np.array([[5.0, 5, 12, 12]])},
                None),
    "half": ({"e/a.jpg": np.array([[10, 10, 20, 20, 1.0]])},
             {"e/a.jpg": np.array([[10.0, 10, 20, 20], [200.0, 200, 20, 20]])}, None),
    "quirks": ({"e/a.jpg": np.array([[10, 10, 20, 20, 0.9], [11, 11, 20, 20, 0.8]]),
                "e/b.jpg": np.array([[5, 5, 10, 10, 0.95], [50, 50, 10, 10, 0.85]]),
                "e/c.jpg": np.array([[50, 50, 20, 20, 0.7]])},
               {"e/a.jpg": np.array([[10.0, 10, 20, 20]]), "e/b.jpg": np.zeros((0, 4)),
                "e/c.jpg": np.array([[50.0, 50, 20, 20]])},
               {"e/a.jpg": np.array([False]), "e/b.jpg": np.zeros(0, bool),
                "e/c.jpg": np.array([True])}),
    "empty": ({}, {"e/a.jpg": np.array([[10.0, 10, 20, 20]])}, None),
}


def _hand(name):
    results, gt, keep = _HAND[name]
    return results, gt, keep or {k: np.ones(v.shape[0], bool) for k, v in gt.items()}


@pytest.mark.parametrize("fixture", [f"seed{s}" for s in range(6)] + sorted(_HAND))
def test_dataset_eval_equals_root_grader_and_official(fixture):
    if fixture.startswith("seed"):
        gt, keep, results = _random_fixture(int(fixture[4:]))
    else:
        results, gt, keep = _hand(fixture)
    got = wider_eval.dataset_eval(results, gt, keep)
    assert got == root_eval.dataset_eval(results, gt, keep)
    assert abs(got - evaluate_official(results, gt, keep)) < 1e-6
    if fixture == "perfect":
        assert got > 0.99
    if fixture == "empty":
        assert got == 0.0


@pytest.mark.parametrize("case", ["matching", "ignored"])
def test_image_eval_equals_root(case):
    if case == "matching":
        gts, keep = np.array([[10.0, 10, 20, 20], [100, 100, 30, 30]]), np.array([True, True])
        dets = np.array([[10, 10, 20, 20, 0.9], [11, 11, 20, 20, 0.8], [300, 300, 10, 10, 0.7],
                         [100, 100, 30, 30, 0.6]])
        want_flags = [1, 0, 0, 1]
    else:
        gts, keep = np.array([[10.0, 10, 20, 20]]), np.array([False])
        dets = np.array([[10, 10, 20, 20, 0.9]])
        want_flags = [-1]
    scores, flags = wider_eval.image_eval(dets, gts, keep)
    root_scores, root_flags = root_eval.image_eval(dets, gts, keep)
    np.testing.assert_array_equal(flags, want_flags)
    np.testing.assert_array_equal(flags, root_flags)
    np.testing.assert_array_equal(scores, root_scores)


def test_read_results_dir_round_trip_equals_root(tmp_path):
    dets = np.array([[10.0, 20.0, 50.0, 80.0, 0.5], [1.2, 3.7, 9.9, 19.1, 0.25]])
    write_results(dets, "ev/img.jpg", "val", results_dir=tmp_path / "port")
    jax_write_results(dets, "ev/img.jpg", "val", results_dir=tmp_path / "jax")
    write_results(np.zeros((0, 5)), "ev2/none.jpg", "val", results_dir=tmp_path / "port")
    got = wider_eval.read_results_dir(tmp_path / "port")
    assert set(got) == {"ev/img.jpg", "ev2/none.jpg"} and got["ev2/none.jpg"].shape == (0, 5)
    np.testing.assert_allclose(got["ev/img.jpg"][0], [10, 20, 41, 61, 0.5])
    want = root_eval.read_results_dir(tmp_path / "jax")
    np.testing.assert_array_equal(got["ev/img.jpg"], want["ev/img.jpg"])


def _write_mats(tmp_path):
    """Official-structure eval_tools ground-truth .mat files (as
    tests/test_wider_eval.py builds them)."""
    scipy_io = pytest.importorskip("scipy.io")
    gdir = tmp_path / "ground_truth"
    gdir.mkdir()
    events = np.array([["0--Ev"]], dtype=object)
    file_list = np.empty((1, 1), dtype=object)
    file_list[0, 0] = np.array([["imA"], ["imB"]], dtype=object)
    bbx = np.empty((2, 1), dtype=object)
    bbx[0, 0] = np.array([[10.0, 10, 20, 20], [50, 50, 30, 30]])
    bbx[1, 0] = np.zeros((0, 4))
    face_bbx_list = np.empty((1, 1), dtype=object)
    face_bbx_list[0, 0] = bbx
    scipy_io.savemat(gdir / "wider_face_val.mat", {
        "event_list": events, "file_list": file_list, "face_bbx_list": face_bbx_list})
    for name, keep_rows in (("easy", [1]), ("medium", [1, 2]), ("hard", [1, 2])):
        gt_list = np.empty((1, 1), dtype=object)
        inner = np.empty((2, 1), dtype=object)
        inner[0, 0] = np.array(keep_rows, float).reshape(-1, 1)
        inner[1, 0] = np.zeros((0, 0))
        gt_list[0, 0] = inner
        scipy_io.savemat(gdir / f"wider_{name}_val.mat", {"gt_list": gt_list})


def test_gt_from_mats_equals_root(tmp_path):
    _write_mats(tmp_path)
    gt, keep = wider_eval.gt_from_mats(tmp_path)
    root_gt, root_keep = root_eval.gt_from_mats(tmp_path)
    assert gt.keys() == root_gt.keys() == {"0--Ev/imA.jpg", "0--Ev/imB.jpg"}
    for k in gt:
        np.testing.assert_array_equal(gt[k], root_gt[k])
    for split in ("easy", "medium", "hard"):
        for k in gt:
            np.testing.assert_array_equal(keep[split][k], root_keep[split][k])
    np.testing.assert_array_equal(keep["easy"]["0--Ev/imA.jpg"], [True, False])
    results = {"0--Ev/imA.jpg": np.array([[10.0, 10, 20, 20, 2.0], [50, 50, 30, 30, 1.0]]),
               "0--Ev/imB.jpg": np.zeros((0, 5))}
    assert wider_eval.dataset_eval(results, gt, keep["easy"]) > 0.99


def _annotations(tmp_path):
    """An annotation file with invalid faces, a zero-face image and faces in
    every height band; and a result tree of jittered detections."""
    rng = np.random.default_rng(11)
    lines, res = [], tmp_path / "results"
    for i in range(6):
        rel = f"{i % 2}--Ev/im{i}.jpg"
        n = 0 if i == 4 else int(rng.integers(2, 8))
        lines += [rel, str(n)]
        if n == 0:
            lines.append("0 0 0 0 0 0 0 0 0 0")
        boxes = []
        for _ in range(n):
            x, y = rng.integers(0, 400, 2)
            h = int(rng.choice([8, 15, 35, 60, 140]))
            w = max(1, int(h * rng.uniform(0.7, 1.0)))
            lines.append(f"{x} {y} {w} {h} 0 0 0 {int(rng.random() < 0.2)} 0 0")
            boxes.append([x, y, x + w - 1, y + h - 1])
        dets = [[*(np.array(b, float) + rng.normal(0, 1.5, 4)), rng.uniform(0.1, 1)]
                for b in boxes if rng.random() < 0.8]
        dets += [[450, 450, 480, 490, rng.uniform(0.1, 1)]]
        write_results(np.array(dets), rel, "val", results_dir=res)
    ann = tmp_path / "wider_face_val_bbx_gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    return ann, res


def test_gt_from_txt_and_cli_equal_root(tmp_path, monkeypatch, capsys):
    ann, res = _annotations(tmp_path)
    gt, keeps = wider_eval.gt_from_txt(ann)
    root_gt, root_keeps = root_eval.gt_from_txt(ann)
    assert gt.keys() == root_gt.keys() and keeps.keys() == root_keeps.keys()
    for k in gt:
        np.testing.assert_array_equal(gt[k], root_gt[k])
        for split in keeps:
            np.testing.assert_array_equal(keeps[split][k], root_keeps[split][k])

    scores = wider_eval.main([str(ann), "--results-dir", str(res), "--out", str(tmp_path / "p.json")])
    ours = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["wider_eval.py", str(ann), "--results-dir", str(res),
                                      "--out", str(tmp_path / "r.json")])
    root_eval.main()
    assert capsys.readouterr().out == ours
    assert json.loads((tmp_path / "p.json").read_text()) == json.loads((tmp_path / "r.json").read_text())
    assert 0.0 < scores["all"] < 1.0 and "AP (hard~)" in ours


@pytest.mark.parametrize("use_07", [False, True])
def test_voc_ap_and_average_precision_equal_jax(use_07):
    rng = np.random.default_rng(3)
    rec = np.sort(rng.random(40))
    prec = rng.random(40)
    assert metrics.voc_ap(rec, prec, use_07) == jax_metrics.voc_ap(rec, prec, use_07)

    n_img, class_recs, dets, conf, ids = 8, {}, [], [], []
    for i in range(n_img):
        n = int(rng.integers(0, 5))
        xywh = np.concatenate([rng.uniform(0, 200, (n, 2)), rng.uniform(10, 60, (n, 2))], 1)
        class_recs[i] = {"bbox": xywh, "det": [False] * n}
        for j in range(n + 1):
            base = xywh[j] if j < n else np.array([300, 300, 30, 30.0])
            d = base + rng.normal(0, 3, 4)
            dets.append([d[0], d[1], d[0] + d[2] - 1, d[1] + d[3] - 1])
            conf.append(rng.random())
            ids.append(i)
    npos = sum(len(r["det"]) for r in class_recs.values())
    copy = lambda: {k: {"bbox": v["bbox"], "det": list(v["det"])} for k, v in class_recs.items()}  # noqa: E731
    ours = metrics.average_precision(np.array(conf), np.array(dets), ids, copy(), npos)
    theirs = jax_metrics.average_precision(np.array(conf), np.array(dets), ids, copy(), npos)
    assert ours[0] == theirs[0] and 0 < ours[0] < 1
    np.testing.assert_array_equal(ours[1], theirs[1])
    np.testing.assert_array_equal(ours[2], theirs[2])


def test_compute_model_score_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    gt, preds = [], []
    for i in range(5):
        boxes = [[float(v) for v in rng.uniform(0, 100, 2)] + [20.0, 30.0] for _ in range(3)]
        gt.append({"image": {"id": i}, "bboxes": [{"category_id": 3 if k < 2 else 1, "bbox": b}
                                                  for k, b in enumerate(boxes)]})
        dets = [[b[0] + 1, b[1], b[0] + b[2], b[1] + b[3] - 1] for b in boxes[:2]]
        preds.append({"id": i, "confidences": list(rng.random(2)), "bboxes": dets})
    (tmp_path / "gt.json").write_text(json.dumps(gt))
    (tmp_path / "pred.jsonl").write_text("\n".join(json.dumps(p) for p in preds) + "\n")
    ours = metrics.compute_model_score(str(tmp_path / "pred.jsonl"), str(tmp_path / "gt.json"))
    theirs = jax_metrics.compute_model_score(str(tmp_path / "pred.jsonl"), str(tmp_path / "gt.json"))
    assert ours[0] == theirs[0] > 0.5
    np.testing.assert_array_equal(ours[2], theirs[2])


def test_box_distances_match_jax_with_quirks():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.uniform(0, 50, (64, 2)), rng.uniform(50, 120, (64, 2))], 1)
    b = np.concatenate([rng.uniform(0, 80, (64, 2)), rng.uniform(40, 160, (64, 2))], 1)
    b[:8] = [200, 200, 210, 210]  # disjoint: the gate drops the intersection
    b[8] = a[8]
    np.testing.assert_allclose(metrics.rect_dist(a, b), np.asarray(jax_metrics.rect_dist(a, b)),
                               atol=1e-6, rtol=0)
    assert (metrics.rect_dist(a[:8], b[:8]) == 1.0).all() and metrics.rect_dist(a[8], b[8]) == 0.0
    for i in range(16):
        got = metrics.jaccard_index(a[i], b[i])
        np.testing.assert_allclose(got, float(jax_metrics.jaccard_index(a[i], b[i])), atol=1e-6)
    # the unclamped intersection: boxes disjoint along x give a negative IoU
    left, right = np.array([0.0, 0, 10, 10]), np.array([20.0, 0, 30, 10])
    assert metrics.jaccard_index(left, right) == pytest.approx(-1 / 3)
    assert float(jax_metrics.jaccard_index(left, right)) == pytest.approx(-1 / 3)

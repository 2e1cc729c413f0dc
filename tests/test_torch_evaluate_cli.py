"""The port's evaluation sweep and CLIs against the JAX package's, on a
synthetic WIDER val tree (PIL-written JPEGs and an annotation file).

The two `run`s share one tiny model's weights (tests/test_torch_evaluation.py),
fp32 on the `rgb` wire, and must write result trees that agree at the
composition tolerances (same files, same detection counts, boxes within
1e-2 px, scores within 1e-3); wider_eval.py then grades both to the same AP
against ground truth taken from some of the detections.
"""

import numpy as np
import pytest
from PIL import Image

import evaluate_model as jax_cli
import wider_eval
from tests.test_torch_evaluation import EC, PROB, TEMPLATES, detectors, shared_weights
from tests.test_torch_native import jax_native_library  # noqa: F401
from tinyfaces_tpu.data import WIDERFace as JaxWIDERFace
from tinyfaces_tpu.data.wider_face import parse_wider_annotations as jax_parse
from tinyfaces_tpu_torch import detect_image
from tinyfaces_tpu_torch import evaluate_model as cli
from tinyfaces_tpu_torch.data import WIDERFace, get_dataloader, parse_wider_annotations

SIZES = [(70, 90), (64, 100), (120, 96), (80, 80), (130, 150), (60, 75), (100, 128)]


def _tree(tmp_path):
    """WIDER_val/images/<event>/<name>.jpg plus a bbx_gt annotation file
    with one face (or none) per image."""
    rng = np.random.default_rng(0)
    lines = []
    for i, (h, w) in enumerate(SIZES):
        rel = f"{i % 2}--Event{i % 2}/img_{i}.jpg"
        path = tmp_path / "WIDER_val" / "images" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path, quality=90)
        if i == 3:
            lines += [rel, "0", "0 0 0 0 0 0 0 0 0 0"]
        else:
            lines += [rel, "2", "5 6 20 24 0 0 0 0 0 0", "30 10 0 15 1 0 0 0 0 0"]
    ann = tmp_path / "wider_face_val_bbx_gt.txt"
    ann.write_text("\n".join(lines) + "\n")
    return ann


def test_parse_wider_annotations_matches_jax(tmp_path):
    ann = _tree(tmp_path)
    got, want = parse_wider_annotations(ann, "val"), jax_parse(ann, "val")
    assert len(got) == len(want) == len(SIZES)
    for g, w in zip(got, want):
        assert g.img_path == w.img_path
        np.testing.assert_array_equal(g.bboxes, w.bboxes)
        assert g.attrs.keys() == w.attrs.keys()
        for k in g.attrs:
            np.testing.assert_array_equal(g.attrs[k], w.attrs[k])
    test_list = tmp_path / "test.txt"
    test_list.write_text("a/b.jpg\n\nc/d.jpg\n")
    assert [s.img_path for s in parse_wider_annotations(test_list, "test")] == \
        [s.img_path for s in jax_parse(test_list, "test")]
    train = WIDERFace(ann, TEMPLATES, split="train")  # the train split reads the same file
    assert len(train) == len(SIZES) and train.image_path(0).parts[-4] == "WIDER_train"


def _read_tree(root):
    return {p.relative_to(root).as_posix(): p.read_text().splitlines() for p in root.glob("*/*.txt")}


def test_run_matches_jax_and_grades_the_same(tmp_path):
    ann = _tree(tmp_path)
    jd, td = detectors(*shared_weights())
    ours = WIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    theirs = JaxWIDERFace(ann, TEMPLATES, dataset_root=tmp_path, split="val")
    for eval_batch in (4, 1):
        out_p, out_j = tmp_path / f"port{eval_batch}", tmp_path / f"jax{eval_batch}"
        cli.run(td, ours, PROB, 0.3, "val", results_dir=out_p, eval_batch=eval_batch, workers=2)
        jax_cli.run(jd, theirs, PROB, 0.3, "val", results_dir=out_j, eval_batch=eval_batch,
                    workers=2)
        got, want = _read_tree(out_p), _read_tree(out_j)
        assert got.keys() == want.keys() and len(got) == len(SIZES)
        assert sum(int(v[1]) for v in want.values()) > 30
        for name in want:
            g, w = got[name], want[name]
            assert g[:2] == w[:2]
            if len(w) > 2:
                gv = np.array([r.split() for r in g[2:]], float)
                wv = np.array([r.split() for r in w[2:]], float)
                # rounded integer boxes: a 1e-2 px difference may flip a rounding
                np.testing.assert_allclose(gv[:, :4], wv[:, :4], atol=1, rtol=0)
                np.testing.assert_allclose(gv[:, 4], wv[:, 4], atol=1e-3, rtol=0)
    assert cli.run.last_phases is None  # eval_batch 1 takes the per-image path

    # Ground truth from the JAX detections (top 2 per image) so AP is not 0.
    res_j = wider_eval.read_results_dir(tmp_path / "jax4")
    lines = []
    for name, rows in sorted(res_j.items()):
        lines += [name, str(min(2, len(rows)))]
        lines += [" ".join(str(int(v)) for v in r[:4]) + " 0 0 0 0 0 0" for r in rows[:2]]
        if not len(rows):
            lines.append("0 0 0 0 0 0 0 0 0 0")
    gt_file = tmp_path / "gt.txt"
    gt_file.write_text("\n".join(lines) + "\n")
    gt, keeps = wider_eval.gt_from_txt(gt_file)
    res_p = wider_eval.read_results_dir(tmp_path / "port4")
    aps = [(wider_eval.dataset_eval(res_p, gt, keep), wider_eval.dataset_eval(res_j, gt, keep))
           for keep in keeps.values()]
    assert aps[0][1] > 0.1
    for a, b in aps:
        assert a == pytest.approx(b, abs=1e-6)


def test_argument_surface_matches_jax(tmp_path):
    ours = vars(cli.arguments(["val.txt"]))
    theirs = vars(jax_cli.arguments(["val.txt"]))
    assert ours.pop("device") == "cuda"  # the port's own flag
    assert ours["transfer"] == theirs["transfer"] == "jpegdct"
    assert ours == theirs
    flags = ["--bf16", "--fp32", "--eval-batch", "8", "--host-resize", "--template-pruning",
             "natural", "--num-processes", "2", "--process-id", "1", "--arch", "resnet50"]
    mine = vars(cli.arguments(["v.txt", *flags, "--transfer", "rgb"]))
    for k, v in vars(jax_cli.arguments(["v.txt", *flags, "--transfer", "rgb"])).items():
        assert mine[k] == v

    ann = _tree(tmp_path)
    # yuv420 and jpegdct4 run (tests/test_torch_{yuv420,jpegdct4}.py); pil needs rgb;
    # spatial and auto sharding need --data-parallel (tests/test_torch_spatial.py)
    for extra, item in ((["--transfer", "jpegdct4", "--resample", "pil"], "transfer='rgb'"),
                        (["--transfer", "yuv420", "--resample", "pil"], "transfer='rgb'"),
                        (["--resample", "pil"], "transfer='rgb'"),
                        (["--shard", "auto"], "requires --data-parallel"),
                        (["--shard", "spatial"], "requires --data-parallel"),
                        (["--bf16", "--fp32"], "exclusive")):
        with pytest.raises(SystemExit, match=item):
            cli.main([str(ann), "--device", "cpu", *extra])
    with pytest.raises(ValueError, match="does not fit split"):
        get_dataloader(ann, None, train=True)
    assert vars(detect_image.arguments(["x.jpg"])) == {
        **vars(__import__("detect_image").arguments(["x.jpg"])), "transfer": "rgb",
        "device": "cuda"}


def test_cli_mains_run_on_the_cpu(tmp_path):
    """Both CLIs end to end at full ResNet-50 width on small images."""
    ann = _tree(tmp_path)
    cli.main([str(ann), "--dataset-root", str(tmp_path), "--device", "cpu", "--fp32",
              "--arch", "resnet50", "--eval-batch", "4", "--workers", "2",
              "--results_dir", str(tmp_path / "res"), "--debug"])
    files = sorted((tmp_path / "res").glob("*/*.txt"))
    assert len(files) == 5
    for f in files:
        lines = f.read_text().splitlines()
        assert lines[0] == f.stem + ".jpg" and int(lines[1]) == len(lines) - 2

    out = tmp_path / "annotated.png"
    detect_image.main([str(tmp_path / "WIDER_val/images/0--Event0/img_0.jpg"), "--device", "cpu",
                       "--arch", "resnet50", "--prob_thresh", "0.5", "--output", str(out)])
    assert Image.open(out).size == (SIZES[0][1], SIZES[0][0])

"""The port's closed-loop accuracy tools (tinyfaces_tpu_torch/tools/) on the
CPU at a tiny size.

- The painted trees are those of the JAX package's tools, byte for byte.
- recall_bands equals the root tool's numbers on a small result tree.
- run_main builds the training CLI's argv, signals the child during the
  asked epoch and reads the K1 launches the child reports (the child here is
  a stand-in script; the real CLI's end-of-run line is pinned too).
- e2e_accuracy, ap_cost and train_soak run with their child runners
  replaced: the argv they build and the JSON they write are checked.
- parity_run --synthetic runs for real on --device cpu, with a tiny model.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tools.recall_bands as root_recall
import tools.train_soak as jax_soak
from tinyfaces_tpu_torch import main as train_cli
from tinyfaces_tpu_torch.evaluation import write_results
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.ops import assignment_kernel
from tinyfaces_tpu_torch.tools import ap_cost, e2e_accuracy, parity_run, recall_bands, train_soak


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_trees_equal_the_jax_tools(tmp_path):
    import tools.e2e_accuracy as jax_e2e

    for dist in ("hard", "easy"):
        for seed in (0, 1):
            a, ba = train_soak.paint_faces(np.random.default_rng(seed), 300, 400, dist)
            b, bb = jax_soak.paint_faces(np.random.default_rng(seed), 300, 400, dist)
            assert ba == bb and np.array_equal(a, b)
    ann = train_soak.make_wider_tree(tmp_path / "port", 2, seed=3)
    jax_soak.make_wider_tree(tmp_path / "jax", 2, seed=3)
    assert ann == tmp_path / "port" / "wider_face_split" / "train.txt"
    gt = e2e_accuracy.make_val_tree(tmp_path / "port", 2, seed=5, size=(96, 128))
    assert jax_e2e.make_val_tree(tmp_path / "jax", 2, seed=5, size=(96, 128)).name == gt.name
    ours, theirs = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert len(ours) == 6 and ours == theirs


def _result_tree(tmp_path):
    rng = np.random.default_rng(8)
    lines = []
    for i in range(5):
        rel = f"0--Ev/im{i}.jpg"
        n = 0 if i == 2 else int(rng.integers(3, 12))
        lines += [rel, str(n)] + ([] if n else ["0 0 0 0 0 0 0 0 0 0"])
        dets = []
        for _ in range(n):
            h = int(rng.choice([12, 25, 40, 70, 150]))
            x, y = rng.integers(0, 500, 2)
            lines.append(f"{x} {y} {h} {h} 0 0 0 {int(rng.random() < 0.15)} 0 0")
            if rng.random() < 0.7:
                dets.append([x + rng.normal(0, 2), y, x + h - 1, y + h - 1 + rng.normal(0, 2),
                             rng.random()])
        write_results(np.array(dets).reshape(-1, 5), rel, "val", tmp_path / "res")
    gt = tmp_path / "gt.txt"
    gt.write_text("\n".join(lines) + "\n")
    return tmp_path / "res", gt


def test_recall_bands_equal_the_root_tool(tmp_path, capsys):
    res, gt = _result_tree(tmp_path)
    got = recall_bands.main(["--results", str(res), "--gt", str(gt)])
    assert got == root_recall.recall_bands(res, gt)
    assert json.loads(capsys.readouterr().out) == got
    assert got["gt_total"] > 20 and 0 < got["10-30px"]["recall"] < 1
    assert recall_bands.recall_bands(res, gt, 0.9) == root_recall.recall_bands(res, gt, 0.9)


# A stand-in for the training CLI: two epochs on the console, then it waits
# for SIGTERM and reports its launches as the real CLI does.
_CHILD = r"""
import signal, sys, time
stop = []
signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
print("Epoch: [0][0/1]", flush=True)
time.sleep(0.3)
print("Epoch: [1][0/1]", flush=True)
t0 = time.time()
while not stop and time.time() - t0 < 20:
    time.sleep(0.05)
print("stopped" if stop else "timed out", flush=True)
print("kernel launches: dense_assignment_reductions 7", flush=True)
"""


def test_run_main_argv_sigterm_and_launches(tmp_path, monkeypatch):
    seen = []
    popen = subprocess.Popen

    def stand_in(cmd, **kw):
        seen.append((cmd, kw))
        return popen([sys.executable, "-c", _CHILD], **kw)

    monkeypatch.setattr(train_soak.subprocess, "Popen", stand_in)
    tree = tmp_path / "tree"
    rc, log = train_soak.run_main(tree, tmp_path, tmp_path / "m.jsonl", 3, 2, ["--arch", "resnet50"],
                                  sigterm_epoch=1, device="cpu", transfer="jpegdct")
    assert rc == 0 and "stopped" in log and train_soak.kernel_launches(log + log) == 14
    cmd, kw = seen[0]
    assert cmd[:3] == [sys.executable, "-m", "tinyfaces_tpu_torch.main"]
    assert cmd[3:] == [str(tree / "wider_face_split" / "train.txt"), "unused-val",
                       "--dataset-root", str(tree), "--epochs", "3", "--batch_size", "2",
                       "--workers", "8", "--log-every", "20", "--metrics-log",
                       str(tmp_path / "m.jsonl"), "--transfer", "jpegdct", "--nan-guard",
                       "--save-every", "1000", "--device", "cpu", "--arch", "resnet50"]
    assert kw["cwd"] == tmp_path and kw["env"]["PYTHONPATH"].split(":")[0] == str(train_soak.REPO)
    with pytest.raises(SystemExit, match="item 15"):
        train_soak.run_main(tree, tmp_path, tmp_path / "m.jsonl", 1, 2, [], transfer="yuv420")


def test_training_cli_reports_its_launches(monkeypatch, capsys):
    monkeypatch.setattr(train_cli, "run", lambda args: None)
    monkeypatch.setattr(assignment_kernel, "launch_count", 5)
    train_cli.main(["t.txt", "v.txt", "--device", "cpu"])
    assert train_soak.kernel_launches(capsys.readouterr().out) == 5


def _fake_training(calls, launches=4, steps=3):
    """A run_main that records its call, writes metrics rows and the
    checkpoint the real CLI would, and reports `launches`."""
    def fake(tree, workdir, metrics, epochs, batch, extra, sigterm_epoch=-1, device="cuda",
             transfer="rgb"):
        calls.append(dict(epochs=epochs, batch=batch, extra=extra, sigterm_epoch=sigterm_epoch,
                          device=device, transfer=transfer))
        resume = "--resume" in extra
        start = int(Path(extra[extra.index("--resume") + 1]).name.split("_")[1]) if resume else 0
        stop = epochs if (resume or sigterm_epoch < 0) else sigterm_epoch + 1
        rows = []
        for e in range(start, stop):
            rows += [{"epoch": e, "step": s, "loss_cls": 9.0 - e, "loss_cls_step": 8.0 - e - s / 10,
                      "images_per_sec": 70.0 + e} for s in range(steps)]
            rows.append({"epoch": e, "event": "epoch_end", "images_per_sec": 70.0 + e})
        with open(metrics, "a") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
        (workdir / "weights").mkdir(exist_ok=True)
        (workdir / "weights" / f"checkpoint_{stop}").write_bytes(b"x")
        return 0, f"kernel launches: dense_assignment_reductions {launches}\n"
    return fake


def _fake_children(seen, gt_file):
    """A subprocess.run that records argv and writes what parity_run would:
    its JSON and, under cwd/parity_val_results, the val GT as detections."""
    def fake(cmd, cwd=None, env=None, **kw):
        seen.append((cmd, Path(cwd), env))
        out = Path(cmd[cmd.index("--out") + 1])
        from tinyfaces_tpu_torch import wider_eval

        gt, _ = wider_eval.gt_from_txt(gt_file)
        for img, xywh in gt.items():
            rows = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:] - 1,
                                   np.ones((len(xywh), 1))], 1)
            write_results(rows, img, "val", Path(cwd) / "parity_val_results")
        bf16 = "--bf16" in cmd
        out.write_text(json.dumps({"scores": {"all": 0.5 + 0.1 * bf16, "easy~": 0.7, "medium~": 0.6,
                                              "hard~": 0.4}, "images_per_sec": 20.0 + 60 * bf16,
                                   "images_per_sec_steady": None, "first_fetch_s": 0.1,
                                   "device": "cpu"}))
        return subprocess.CompletedProcess(cmd, 0)
    return fake


@pytest.mark.parametrize("sigterm_epoch", [-1, 1])
def test_e2e_accuracy_drives_train_eval_and_grading(tmp_path, monkeypatch, sigterm_epoch):
    calls, seen = [], []
    monkeypatch.setattr(e2e_accuracy, "run_main", _fake_training(calls))
    gt_file = tmp_path / "wider" / "wider_face_split" / "wider_face_val_bbx_gt.txt"
    monkeypatch.setattr(e2e_accuracy.subprocess, "run", _fake_children(seen, gt_file))
    result = e2e_accuracy.main(["--workdir", str(tmp_path), "--train-images", "2", "--val-images",
                                "2", "--val-size", "96x128", "--epochs", "3", "--batch", "2",
                                "--device", "cpu", "--sigterm-epoch", str(sigterm_epoch)])
    assert json.loads((tmp_path / "E2E_ACCURACY.json").read_text()) == result
    assert [c["extra"][:4] for c in calls] == [["--arch", "resnet101", "--save-every", "3"]] * len(calls)
    assert all(c["device"] == "cpu" and c["transfer"] == "rgb" and c["batch"] == 2 for c in calls)
    if sigterm_epoch < 0:
        assert len(calls) == 1 and result["resume_seam"] is None and result["k1_launches"] == 4
    else:
        assert calls[0]["sigterm_epoch"] == 1 and calls[1]["extra"][-2:] == [
            "--resume", str(tmp_path / "weights" / "checkpoint_2")]
        assert result["resume_seam"]["resumed_at_epoch"] == 2 and result["k1_launches"] == 8
    cmd, cwd, env = seen[0]
    assert cmd[1:3] == ["-m", "tinyfaces_tpu_torch.tools.parity_run"] and cwd == tmp_path
    for flag, value in (("--resample", "linear"), ("--transfer", "jpegdct"), ("--device", "cpu"),
                        ("--checkpoint", str(tmp_path / "weights" / "checkpoint_3")),
                        ("--eval-batch", "32"), ("--ab-images", "0")):
        assert cmd[cmd.index(flag) + 1] == value
    assert "--bf16" in cmd and env["PYTHONPATH"].startswith(str(train_soak.REPO))
    assert result["ap"]["all"] == 0.6 and result["device"] == "cpu"
    assert result["recall_by_height"]["gt_total"] > 0
    assert all(v["recall"] == 1.0 for k, v in result["recall_by_height"].items()
               if k.endswith("px") and v["gt"])
    assert result["loss_cls_per_epoch"][0] > result["loss_cls_per_epoch"][-1]
    with pytest.raises(SystemExit, match="item 15"):
        e2e_accuracy.main(["--workdir", str(tmp_path), "--train-transfer", "yuv420"])


def test_ap_cost_runs_the_four_configs(tmp_path, monkeypatch):
    seen = []
    (tmp_path / "weights").mkdir()
    (tmp_path / "weights" / "checkpoint_5").write_bytes(b"x")
    gt_file = tmp_path / "gt.txt"
    gt_file.write_text("0--Ev/a.jpg\n1\n10 10 20 20 0 0 0 0 0 0\n")
    monkeypatch.setattr(ap_cost.subprocess, "run", _fake_children(seen, gt_file))
    payload = ap_cost.main(["--workdir", str(tmp_path), "--epochs", "5", "--device", "cpu"])
    assert json.loads((tmp_path / "AP_COST.json").read_text()) == payload
    assert list(payload["configs"]) == [name for name, _ in ap_cost.CONFIGS]
    for (cmd, cwd, _), (name, flags) in zip(seen, ap_cost.CONFIGS):
        assert cmd[-len(flags):] == flags and cwd == tmp_path
        assert cmd[cmd.index("--device") + 1] == "cpu" and cmd[cmd.index("--ab-images") + 1] == "0"
    deltas = {k: v["delta_vs_reference_exact"]["all"] for k, v in payload["configs"].items()}
    assert deltas["fp32+rgb+pil"] == 0.0 and deltas["bf16+rgb+pil"] == pytest.approx(0.1)
    assert payload["production_default_ap_cost"]["all"] == pytest.approx(0.1)
    assert payload["acceptable"] is False
    with pytest.raises(SystemExit, match="checkpoint not found"):
        ap_cost.main(["--workdir", str(tmp_path), "--epochs", "4"])


@pytest.mark.parametrize("tool", ["e2e_accuracy", "ap_cost", "train_soak"])
def test_a_relative_workdir_gives_the_children_absolute_paths(tmp_path, monkeypatch, tool):
    """The children run in the work directory, so every path they are
    handed must not depend on the parent's working directory."""
    monkeypatch.chdir(tmp_path)
    paths, seen = [], []

    def recording(fake):
        def run(tree, workdir, metrics, *a, **kw):
            paths.extend([tree, workdir, metrics])
            return fake(tree, workdir, metrics, *a, **kw)
        return run

    work = tmp_path / "rel" / "work"
    if tool == "e2e_accuracy":
        monkeypatch.setattr(e2e_accuracy, "run_main", recording(_fake_training([])))
        gt_file = work / "wider" / "wider_face_split" / "wider_face_val_bbx_gt.txt"
        monkeypatch.setattr(e2e_accuracy.subprocess, "run", _fake_children(seen, gt_file))
        e2e_accuracy.main(["--workdir", "rel/work", "--train-images", "2", "--val-images", "1",
                           "--val-size", "96x128", "--epochs", "1", "--batch", "2",
                           "--device", "cpu"])
    elif tool == "ap_cost":
        (work / "weights").mkdir(parents=True)
        (work / "weights" / "checkpoint_1").write_bytes(b"x")
        gt_file = tmp_path / "gt.txt"
        gt_file.write_text("0--Ev/a.jpg\n1\n10 10 20 20 0 0 0 0 0 0\n")
        monkeypatch.setattr(ap_cost.subprocess, "run", _fake_children(seen, gt_file))
        ap_cost.main(["--workdir", "rel/work", "--epochs", "1", "--device", "cpu"])
    else:
        monkeypatch.setattr(train_soak, "run_main", recording(_fake_training([])))
        monkeypatch.setattr(train_soak, "make_wider_tree", lambda root, n: root.mkdir(parents=True))
        train_soak.main(["--workdir", "rel/work", "--images", "4", "--batch", "2", "--epochs", "3",
                         "--device", "cpu"])
    for cmd, cwd, _ in seen:
        paths += [cwd] + [Path(cmd[cmd.index(f) + 1]) for f in ("--dataset-root", "--checkpoint", "--out")]
    assert paths and all(Path(p).is_absolute() for p in paths), paths


def test_train_soak_sigterm_and_resume(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(train_soak, "run_main", _fake_training(calls, launches=6))
    monkeypatch.setattr(train_soak, "make_wider_tree", lambda root, n: root.mkdir(parents=True))
    result = train_soak.main(["--workdir", str(tmp_path), "--images", "4", "--batch", "2",
                              "--epochs", "5", "--device", "cpu", "--transfer", "jpegdct"])
    assert [c["sigterm_epoch"] for c in calls] == [2, -1]  # 40% of 5 epochs
    assert calls[1]["extra"] == ["--arch", "resnet101", "--resume",
                                 str(tmp_path / "weights" / "checkpoint_3")]
    assert result["resume_continued_at_epoch"] == 3 and result["k1_launches"] == 12
    assert result["total_steps"] == 10 and result["descended"] and result["seam_ok"]
    assert json.loads((tmp_path / "TRAIN_SOAK.json").read_text()) == result


def test_parity_run_synthetic_on_the_cpu(tmp_path, monkeypatch):
    def tiny_model(checkpoint, num_templates, dtype, arch, device):
        assert checkpoint is None and arch == "resnet101" and str(device) == "cpu"
        model = init_model(TinyFacesDetector(stage_sizes=(1, 1, 1), dtype=dtype),
                           torch.Generator().manual_seed(0))
        with torch.no_grad():
            model.score_res3.bias[:25] -= 2.0
        return model.eval()

    monkeypatch.setattr(parity_run, "get_model", tiny_model)
    monkeypatch.chdir(tmp_path)
    payload = parity_run.main(["--synthetic", "2", "--dataset-root", str(tmp_path / "root"),
                               "--ab-images", "1", "--eval-batch", "2", "--device", "cpu",
                               "--prob_thresh", "0.1"])
    assert json.loads((tmp_path / "parity_scores.json").read_text()) == payload
    assert payload["resample"] == "pil" and payload["transfer"] == "rgb" and not payload["bf16"]
    assert payload["synthetic_smoke"] and payload["approximate_splits"] and payload["verdict"] is None
    assert set(payload["scores"]) == {"all", "easy~", "medium~", "hard~"}
    assert all(0.0 <= v <= 1.0 for v in payload["scores"].values())
    assert payload["ab_check"]["images"] == 1 and payload["device"] == "cpu"
    assert len(list((tmp_path / "parity_val_results").glob("*/*.txt"))) == 2
    with pytest.raises(SystemExit, match="item 15"):
        parity_run.main(["--synthetic", "1", "--transfer", "yuv420", "--device", "cpu"])

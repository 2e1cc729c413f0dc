"""The port's training CLI (`python -m tinyfaces_tpu_torch.main`) on the CPU.

Its flags equal the JAX package's main.py in names, defaults and choices,
plus `--device`. End to end at a cut depth (ResNet-50's stages set to
(1, 1, 1)), batch 2, on a small JPEG tree: `--epochs 1` and then `--resume
weights/checkpoint_1 --epochs 2` leave a state_dict bit-equal to an
uninterrupted `--epochs 2` run; the JSONL records carry the JAX trainer's
keys; SIGTERM during epoch 0 writes checkpoint_1 and stops (`--transfer
yuv420`: tests/test_torch_yuv420.py); multi-process runs that cannot start
exit, and `--device cuda` without a GPU
exits; without `--bf16` TF32 is off. A reference .pth reads as the JAX package's converter reads it, and
`--pretrained-backbone` loads only its backbone.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import signal
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_main
from tests.test_torch_wider_train import write_train_tree
from tinyfaces_tpu.config import DetectorConfig as JaxDetectorConfig
from tinyfaces_tpu.config import TrainConfig as JaxTrainConfig
from tinyfaces_tpu.data import wider_face as jax_wf
from tinyfaces_tpu.loss import LossBreakdown as JaxLossBreakdown
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.parallel.mesh import make_mesh
from tinyfaces_tpu.trainer import Trainer as JaxTrainer
from tinyfaces_tpu_torch import main as cli
from tinyfaces_tpu_torch.data import load_templates, native
from tinyfaces_tpu_torch.data import wider_face as wf
from tinyfaces_tpu_torch.models import detection
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.trainer import load_checkpoint
from tinyfaces_tpu_torch.utils.convert import from_jax, from_reference_pth

SIZES = [(180, 240), (240, 160), (150, 150), (200, 260)]
FACES = [3, 0, 14, 5]


def _parser(module, monkeypatch):
    """The ArgumentParser a module's `arguments` builds."""
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", lambda self, argv=None: self)
    parser = module.arguments([])
    monkeypatch.undo()
    return parser


def test_flags_match_jax(monkeypatch):
    def surface(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs, type(a))
                for a in parser._actions}

    ours, theirs = surface(_parser(cli, monkeypatch)), surface(_parser(jax_main, monkeypatch))
    assert ours.pop("device") == (("--device",), "cuda", None, None, None, argparse._StoreAction)
    # the port's --arch adds ViTDet-B to the JAX package's two ResNets
    arch = theirs.pop("arch")
    assert ours.pop("arch") == (arch[0], arch[1], (*arch[2], "vitdet_b"), *arch[3:])
    assert ours == theirs
    argv = ["t.txt", "v.txt", "--epochs", "3", "--resume", "w/c", "--bf16", "--max-gt", "8"]
    assert vars(cli.arguments(argv)) == {**vars(jax_main.arguments(argv)), "device": "cuda"}


@pytest.fixture
def tree(tmp_path):
    return write_train_tree(tmp_path / "data", sizes=SIZES, faces=FACES)


def _argv(tree, *extra):
    return [str(tree), str(tree), "--dataset-root", str(tree.parent), "--device", "cpu",
            "--arch", "resnet50", "--batch_size", "2", "--workers", "2", "--max-gt", "8",
            "--seed", "3", *extra]


def _run(tmp_path, monkeypatch, name, argv, dataset=None):
    run_dir = tmp_path / name
    run_dir.mkdir()
    monkeypatch.chdir(run_dir)
    monkeypatch.setitem(detection.ARCHS, "resnet50", dataclasses.replace(detection.ARCHS["resnet50"],
                                                                         stages=(1, 1, 1)))
    return cli.run(cli.arguments(argv), dataset), run_dir


def _records(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _jax_records(tree, path):
    """The JSONL records of the JAX trainer's epoch loop over the same tree
    (its train step replaced by constants: only the records' keys matter)."""
    cfg = JaxDetectorConfig(max_gt=8)
    trainer = JaxTrainer(JaxDetector(stage_sizes=(1, 1, 1)), cfg, JaxTrainConfig(batch_size=2, workers=2),
                         load_templates(), mesh=make_mesh(jax.devices()[:1]), metrics_path=path)
    one = jnp.float32(1.0)
    trainer.step_fn = lambda state, batch, key: (state, JaxLossBreakdown(one, one, one))
    trainer.train_epoch(None, jax_wf.WIDERFace(tree, load_templates(), cfg=cfg,
                                               dataset_root=tree.parent), 0)
    trainer.metrics.close()
    return _records(path)


def test_resume_is_bit_exact_and_records_match_jax(tree, tmp_path, monkeypatch):
    samples = native.counters["samples"]
    full, full_dir = _run(tmp_path, monkeypatch, "full", _argv(
        tree, "--epochs", "2", "--save-every", "1", "--async-checkpoint",
        "--metrics-log", "metrics.jsonl", "--profile-dir", "trace"))
    assert native.counters["samples"] - samples == 8  # every sample through the C++ engine
    assert (full_dir / "trace" / "trace.json").stat().st_size > 0
    spans = json.loads((full_dir / "trace" / "spans.json").read_text())["spans"]  # the first epoch's
    assert [s["attrs"]["step"] for s in spans if s["name"] == "train.step"] == [0, 1]
    assert [s["attrs"]["path"] for s in spans if s["name"] == "train.step"] == ["eager", "eager"]
    assert {"loader.get", "loader.batch", "loader.decode", "loader.augment"} <= {s["name"] for s in spans}
    first, first_dir = _run(tmp_path, monkeypatch, "first", _argv(tree, "--epochs", "1",
                                                                  "--save-every", "1"))
    resumed, _ = _run(tmp_path, monkeypatch, "resumed", _argv(
        tree, "--resume", str(first_dir / "weights" / "checkpoint_1"), "--epochs", "2"))
    assert full.step == resumed.step == 4 and first.step == 2
    want = full.model.state_dict()
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for name in ("checkpoint_1", "checkpoint_2"):
        payload = load_checkpoint(full_dir / "weights" / name)
        assert payload["epoch"] == int(name[-1]) and payload["step"] == 2 * int(name[-1])
    for k, v in load_checkpoint(full_dir / "weights" / "checkpoint_2")["model"].items():
        assert torch.equal(v, want[k]), k

    records = _records(full_dir / "metrics.jsonl")
    steps = [r for r in records if "event" not in r]
    ends = [r for r in records if r.get("event") == "epoch_end"]
    assert [(r["epoch"], r["step"]) for r in steps] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["epoch"] for r in ends] == [0, 1] and ends[-1]["gt_dropped_boxes"] > 0
    assert all(np.isfinite(r["loss_cls_step"]) for r in steps)
    assert [r["replayed_steps"] for r in ends] == [0, 0]  # the CPU's steps are eager
    assert [r["tuned_steps"] for r in ends] == [1, 0]  # the first step at the batch's shapes
    jax_records = _jax_records(tree, tmp_path / "jax.jsonl")
    # the JAX package's keys, and the port's epoch_end adds its replays and tuned steps
    added = {"replayed_steps", "tuned_steps", "tuned_s"}
    assert {tuple(k for k in r if k not in added) for r in records} == {tuple(r) for r in jax_records}


def test_sigterm_checkpoints_and_stops(tree, tmp_path, monkeypatch):
    class SignalledOnce(wf.WIDERFace):
        """Sends SIGTERM to this process on its first decode (epoch 0)."""
        sent = False

        def _decode(self, idx):
            if not SignalledOnce.sent:
                SignalledOnce.sent = True
                os.kill(os.getpid(), signal.SIGTERM)
            return super()._decode(idx)

    previous = signal.getsignal(signal.SIGTERM)
    dataset = SignalledOnce(tree, load_templates(), cfg=cli.DetectorConfig(max_gt=8),
                            dataset_root=tree.parent)
    trainer, run_dir = _run(tmp_path, monkeypatch, "stopped", _argv(tree, "--epochs", "3"), dataset)
    assert SignalledOnce.sent and trainer.step == 2  # epoch 0 finished, no more
    assert sorted(p.name for p in (run_dir / "weights").iterdir()) == ["checkpoint_1"]
    assert load_checkpoint(run_dir / "weights" / "checkpoint_1")["epoch"] == 1
    assert signal.getsignal(signal.SIGTERM) is previous


@pytest.mark.parametrize("extra,item", [
    (["--transfer", "yuv420", "--num-processes", "3", "--coordinator-address", "file:///x"],
     "global batch"),
    (["--transfer", "jpegdct", "--num-processes", "3", "--coordinator-address", "file:///x"],
     "global batch"),
    (["--num-processes", "2"], "needs --coordinator-address"),
    (["--num-processes", "4", "--coordinator-address", "localhost:1234"], "global batch")])
def test_unported_options_exit(tree, extra, item):
    """Unported options and multi-process runs that cannot start exit
    before any process group is formed (multi-process training itself:
    tests/test_torch_distributed.py)."""
    with pytest.raises(SystemExit, match=item):
        cli.main(_argv(tree, *extra))


def test_cuda_without_a_gpu_exits(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main([str(tree), str(tree), "--dataset-root", str(tree.parent)])


def test_debug_shows_the_first_sample(tree, tmp_path, monkeypatch, capsys):
    from PIL import Image

    shown = []
    monkeypatch.setattr(Image.Image, "show", lambda self, *a, **k: shown.append(self.size))
    assert _run(tmp_path, monkeypatch, "debug", _argv(tree, "--debug"))[0] is None
    assert "positive anchors:" in capsys.readouterr().out and shown == [(500, 500)]


@pytest.mark.parametrize("bf16", [False, True])
def test_fp32_turns_tf32_off(tree, tmp_path, monkeypatch, bf16):
    """Without --bf16 the CLI trains in fp32: TF32 goes off for matmuls and
    convolutions, whatever the process had (cuDNN allows it by default)."""
    from PIL import Image

    monkeypatch.setattr(Image.Image, "show", lambda self, *a, **k: None)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _run(tmp_path, monkeypatch, "debug", _argv(tree, "--debug", *(["--bf16"] if bf16 else [])))
    assert torch.backends.cuda.matmul.allow_tf32 is bf16
    assert torch.backends.cudnn.allow_tf32 is bf16


def test_vitdet_arch_builds_its_model_crop_and_geometry(tree, tmp_path, monkeypatch):
    """`--arch vitdet_b --bf16`: the ViT detector in bfloat16, the 1024x1024
    crop, the 128x128 heat map and the patch grid's receptive field, in the
    Trainer and the dataset alike (the ViT cut to the tests' tiny one)."""
    from tests.test_torch_vitdet import TINY
    from tinyfaces_tpu_torch.models.vitdet import VitDetBackbone
    from tinyfaces_tpu_torch.trainer import Trainer

    monkeypatch.setitem(detection.ARCHS, "vitdet_b", dataclasses.replace(
        detection.ARCHS["vitdet_b"], build=lambda stages, dtype, remat: VitDetBackbone(TINY, dtype),
        channels=(TINY.pyramid_dim,) * 2))
    seen = {}
    monkeypatch.setattr(Trainer, "train_epoch",
                        lambda self, dataset, epoch, log_every=1: seen.update(trainer=self, dataset=dataset))
    argv = _argv(tree, "--arch", "vitdet_b", "--bf16", "--epochs", "1", "--save-every", "5")
    args = cli.arguments(argv)
    assert (args.arch, args.bf16) == ("vitdet_b", True)
    tf32 = torch.backends.cudnn.allow_tf32
    _run(tmp_path, monkeypatch, "vit", argv)
    trainer, dataset = seen["trainer"], seen["dataset"]
    model, cfg = trainer.model, trainer.cfg
    assert model.arch == "vitdet_b" and model.dtype == torch.bfloat16
    assert isinstance(model.model, VitDetBackbone) and model.model.dtype == torch.bfloat16
    assert (cfg.input_size, cfg.heatmap_size, cfg.rf.stride, cfg.rf.offset, cfg.max_gt) == (
        (1024, 1024), (128, 128), (8, 8), (3.5, 3.5), 8)
    assert dataset.cfg == cfg
    assert torch.backends.cudnn.allow_tf32 == tf32  # --bf16 leaves TF32 as it was
    assert {g["name"] for g in trainer.opt.param_groups} == {"backbone", "score_res3", "score_res4"}


def test_pretrained_backbone_from_a_reference_checkpoint(tmp_path):
    """A reference DetectionModel checkpoint (dense upsample, layer4, BN
    counters) reads as the port's state_dict, as the JAX package's converter
    reads it; `--pretrained-backbone` loads only its backbone."""
    source = init_model(TinyFacesDetector(stage_sizes=(1, 1, 1)), torch.Generator().manual_seed(4))
    want = source.state_dict()
    ref = {k: v.clone() for k, v in want.items() if k != "score4_upsample.weight"}
    c = want["score4_upsample.weight"].shape[0]
    dense = torch.zeros(c, c, 4, 4)
    dense[torch.arange(c), torch.arange(c)] = want["score4_upsample.weight"][:, 0]
    ref["score4_upsample.weight"] = dense
    ref["model.layer4.0.conv1.weight"] = torch.ones(3, 3, 1, 1)
    ref["model.fc.weight"] = torch.ones(2, 2)
    ref["model.bn1.num_batches_tracked"] = torch.tensor(5)
    path = tmp_path / "checkpoint_50.pth"
    torch.save({"model": ref, "epoch": 50}, path)

    got = from_reference_pth(path)
    assert got.keys() == want.keys()
    tool = Path(__file__).resolve().parent.parent / "tools" / "convert_torch_checkpoint.py"
    spec = importlib.util.spec_from_file_location("convert_torch_checkpoint", tool)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    tree = module.convert_torch_checkpoint(path)
    via_jax = from_jax(tree["params"], tree["batch_stats"])
    for k, v in want.items():
        assert torch.equal(got[k], v) and torch.equal(via_jax[k], v), k

    target = init_model(TinyFacesDetector(stage_sizes=(1, 1, 1)), torch.Generator().manual_seed(5))
    heads = {k: v.clone() for k, v in target.state_dict().items() if not k.startswith("model.")}
    cli.load_backbone(target, path)
    for k, v in target.state_dict().items():
        assert torch.equal(v, want[k] if k.startswith("model.") else heads[k]), k

"""A run of each cell on the CPU with the timed path broken underneath
comes out not correct, once for each fault the cell can have, and the
sound run comes out correct. Tiny sizes (tests/tiny.py); the CPU twin of
K1 is fed the kernel's own tie-break draws (its mirror, kernel_noise), as
the card computes them. The eval cells (unlisted.json) run on the `rgb`
wire here: on `jpegdct` the port fills the canvas past a side that is not
a multiple of 16 with the codec's padding (PERF.md, Open questions), and
these tests are of the harness's comparison."""

import numpy as np
import pytest
import torch

from perfbench.tests.tiny import run_tiny


@pytest.fixture
def kernel_draws(monkeypatch):
    from tinyfaces_tpu_torch.ops import assignment_kernel as ak

    plain = ak.dense_assignment_reductions_reference

    def with_kernel_noise(gt_boxes, gt_valid, templates, seed, noise_tensor=None, **kw):
        if noise_tensor is None:
            noise_tensor = ak.kernel_noise(seed, kw["vsy"], kw["vsx"], templates.shape[0], gt_boxes.shape[1])
        return plain(gt_boxes, gt_valid, templates, seed, noise_tensor=noise_tensor, **kw)

    monkeypatch.setattr(ak, "dense_assignment_reductions_reference", with_kernel_noise)


def break_fetch(monkeypatch, how):
    from tinyfaces_tpu_torch.evaluation import PyramidDetector

    plain = PyramidDetector._fetch

    def broken(result):
        out = plain(result)
        if how == "half":  # half of the batch left out (a batch of one: all of it)
            out = out[: len(out) // 2] + [np.zeros((0, 5), np.float32)] * (len(out) - len(out) // 2)
        elif how == "altered" and len(out[0]):  # one answer altered where it is produced
            out[0] = out[0].copy()
            w = out[0][0, 2] - out[0][0, 0]
            out[0][0, [0, 2]] += w
        return out

    monkeypatch.setattr(PyramidDetector, "_fetch", staticmethod(broken))


@pytest.mark.parametrize("cell", ["eval-sweep-b32", "eval-serve-poisson"])
def test_eval_sound_run_is_correct(cell):
    line, _ = run_tiny(cell, seconds=1.5, wire="rgb")
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["eval-sweep-b32", "eval-serve-poisson"])
@pytest.mark.parametrize("how", ["half", "altered"])
def test_eval_fault_is_caught(monkeypatch, cell, how):
    break_fetch(monkeypatch, how)
    line, _ = run_tiny(cell, seconds=1.5, wire="rgb")
    assert not line["correct"], line["checks"]


def test_eval_nms_skipped_is_caught(monkeypatch):
    from tinyfaces_tpu_torch.ops import nms

    monkeypatch.setattr(nms, "_plain_keep", lambda boxes, valid, thr: valid.clone())
    line, _ = run_tiny("eval-sweep-b32", seconds=1.5, wire="rgb")
    assert line["checks"]["overlap"]["value"] > line["checks"]["overlap"]["limit"], line["checks"]


def test_train_sound_run_is_correct(kernel_draws):
    line, _ = run_tiny("train-wider-b12", seconds=1.0)
    assert line["correct"], line["checks"]


def test_train_state_unchanged_is_caught(kernel_draws, monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, closure=None: None)
    line, _ = run_tiny("train-wider-b12", seconds=1.0)
    assert not line["correct"] and line["checks"]["change_gap"]["value"] > 0.99, line["checks"]


def test_train_window_step_unchanged_is_caught(kernel_draws, monkeypatch):
    from perfbench.drivers import train as drv

    plain, calls = torch.optim.SGD.step, []

    def after_warm_up(self, closure=None):  # a path that switches in once set-up is over
        calls.append(1)
        return None if len(calls) > drv.CHECK_STEPS else plain(self, closure)

    monkeypatch.setattr(torch.optim.SGD, "step", after_warm_up)
    line, _ = run_tiny("train-wider-b12", seconds=1.0)
    checks = line["checks"]
    assert not line["correct"] and checks["window_gap"]["value"] > 0.9, checks
    assert checks["change_gap"]["value"] <= checks["change_gap"]["limit"], checks


def test_train_augmentation_altered_is_caught(kernel_draws, monkeypatch):
    from tinyfaces_tpu_torch.data import native

    plain = native.native_augment_sample

    def unflipped(*args, **kw):  # the mirror drawn and recorded, the pixels left as they were
        out = plain(*args, **kw)
        if out["flip"]:
            out["image"] = out["image"][:, ::-1].copy()
        return out

    monkeypatch.setattr(native, "native_augment_sample", unflipped)
    line, _ = run_tiny("train-wider-b12", seconds=1.0)
    assert not line["correct"] and line["checks"]["aug_diff"]["value"] > 0, line["checks"]


def test_train_half_batch_is_caught(kernel_draws, monkeypatch):
    from tinyfaces_tpu_torch import trainer
    from tinyfaces_tpu_torch.loss import LossBreakdown

    plain = trainer.detection_loss

    def half(output, cls_map, reg_map, generator, **kw):  # the mean over the rest, scaled up
        h = output.shape[0] // 2
        lb = plain(output[:h], cls_map[:h], reg_map[:h], generator, **kw)
        return LossBreakdown(*(x * (output.shape[0] / h) for x in lb))

    monkeypatch.setattr(trainer, "detection_loss", half)
    line, _ = run_tiny("train-wider-b12", seconds=1.0)
    assert not line["correct"], line["checks"]


def test_train_gradient_altered_is_caught(kernel_draws, monkeypatch):
    plain = torch.optim.SGD.step

    def altered(self, closure=None):  # one leaf's gradient doubled where it is used
        p = self.param_groups[0]["params"][0]
        if p.grad is not None:
            p.grad.mul_(2.0)
        return plain(self, closure)

    monkeypatch.setattr(torch.optim.SGD, "step", altered)
    line, _ = run_tiny("train-wider-b12", seconds=1.0)
    assert not line["correct"], line["checks"]

"""The port's ViTDet-B backbone (models/vitdet.py, `TinyFacesDetector(arch=
"vitdet_b")`) against its plain float32 reference (models/vitdet_reference.py)
on the CPU, at a tiny ViT of the same structure: width 32, 2 heads, 4 blocks
with the global one at index 2, window 3, patch 16 (so the pyramid's finer
level has stride 8 and the head's geometry is ViTDet-B's), a 7x7 position
grid interpolated to the token grid; the 80x80 input's 5x5 token grid pads
to 6x6 in the windowed blocks.

Held: the forward and its gradients, one eager train step against the
reference's train step on the same draws, `get_rel_pos`'s linear
interpolation, the two copies of the reference, the ResNets unchanged by
the registry, the receptive-field geometry (a face placed on a cell gets
its positive anchors at the cell whose derived centre is nearest) and the
eval pyramid's refusal.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from tinyfaces_tpu_torch import evaluation
from tinyfaces_tpu_torch.config import DetectorConfig
from tinyfaces_tpu_torch.data.targets import build_targets
from tinyfaces_tpu_torch.models import detection, vitdet
from tinyfaces_tpu_torch.models import vitdet_reference as R
from tinyfaces_tpu_torch.models.detection import ARCHS, TinyFacesDetector, detector_config, init_model
from tinyfaces_tpu_torch.models.vitdet import VitConfig, VitDetBackbone
from tinyfaces_tpu_torch.trainer import make_optimizer, train_step
from tinyfaces_tpu_torch.utils import graphs, profiling

ROOT = Path(__file__).resolve().parents[1]
TINY = VitConfig(img_size=80, patch_size=16, embed_dim=32, depth=4, num_heads=2, mlp_dim=64, window_size=3,
                 global_blocks=(2,), pretrain_grid=7, pyramid_dim=16)
ARCH = {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(TINY).items()}
T = 3  # templates


@pytest.fixture
def tiny_arch(monkeypatch):
    monkeypatch.setitem(detection.ARCHS, "vitdet_b", dataclasses.replace(
        ARCHS["vitdet_b"], build=lambda stages, dtype, remat: VitDetBackbone(TINY, dtype),
        channels=(TINY.pyramid_dim,) * 2))


def tiny_model(weights, dtype=None):
    model = TinyFacesDetector(num_templates=T, arch="vitdet_b", dtype=dtype)
    model.load_state_dict(weights)
    return model


@pytest.mark.parametrize("hw", [(80, 80), (96, 64)])
def test_forward_equals_reference(tiny_arch, hw):
    w = R.make_weights(3, "cpu", ARCH, T)
    x = torch.randn(2, *hw, 3, generator=torch.Generator().manual_seed(1))
    out = tiny_model(w)(x)
    ref = R.VitDet(w, ARCH).forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.shape == (2, hw[0] // 8, hw[1] // 8, 5 * T)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    # the bias matters: the reference without it is off by more than the tolerance
    nobias = R.VitDet(w, ARCH, rel_pos=False).forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert (nobias - ref).abs().max() > 1e-4


def test_gradients_equal_reference(tiny_arch):
    w = R.make_weights(4, "cpu", ARCH, T)
    x = torch.randn(2, 80, 80, 3, generator=torch.Generator().manual_seed(2))
    model = tiny_model(w)
    (model(x) ** 2).sum().backward()
    ref_w = {k: v.clone().requires_grad_(not k.startswith("score4_")) for k, v in w.items()}
    (R.VitDet(ref_w, ARCH).forward(x.permute(0, 3, 1, 2)) ** 2).sum().backward()
    named = dict(model.named_parameters())
    for k, v in ref_w.items():
        if v.grad is None:
            continue
        assert named[k].grad is not None, k
        scale = float(v.grad.abs().max()) + 1e-12
        assert float((named[k].grad - v.grad).abs().max()) <= 1e-4 * scale, k
    assert float(ref_w[R.NET + "blocks.2.attn.rel_pos_h"].grad.abs().max()) > 0


def test_bf16_forward_near_reference(tiny_arch):
    w = R.make_weights(5, "cpu", ARCH, T)
    x = torch.randn(1, 80, 80, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        out = tiny_model(w, torch.bfloat16)(x)
        ref = R.VitDet(w, ARCH).forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) < 0.05 * float(ref.abs().max())


def test_train_step_equals_reference_step(tiny_arch):
    """One eager step of the port on the reference's draws (its tie-break
    noise fed in) against reference/train's targets, loss and SGD update."""
    from perfbench.reference import train as ref_train
    from perfbench.reference import vitdet_train as ref_vtrain

    templates = np.array([[-12, -16, 12, 16, 0.5], [-6, -8, 6, 8, 0.5], [-24, -30, 24, 30, 1.0]], np.float64)
    cfg = DetectorConfig(num_templates=T, input_size=(80, 80), heatmap_size=(10, 10), max_gt=4,
                         rf=ARCHS["vitdet_b"].rf)
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, :, :2] = rng.uniform(5, 45, (2, 4, 2))
    boxes[:, :, 2:] = boxes[:, :, :2] + rng.uniform(8, 30, (2, 4, 2))
    batch = {"image": torch.from_numpy(rng.integers(0, 256, (2, 80, 80, 3), dtype=np.uint8)),
             "gt_boxes": torch.from_numpy(boxes), "gt_valid": torch.tensor([[1, 1, 1, 0], [1, 1, 0, 0]]).bool(),
             "paste_box": torch.tensor([[0, 0, 80, 80], [4, 2, 76, 80]], dtype=torch.float32),
             "flip": torch.tensor([False, True])}
    w = R.make_weights(6, "cpu", ARCH, T)
    seed, anchors = 11, 10 * 10 * T
    rcfg = {"heatmap_size": (10, 10), "rf_stride": 8, "rf_offset": 3.5, "pos_thresh": 0.7, "neg_thresh": 0.3,
            "hard_neg_thresh": 0.03, "sample_size": 256, "pos_fraction": 0.5, "weight_decay": 5e-4,
            "momentum": 0.9, "lr": 1e-2, "num_templates": T}
    ref = ref_vtrain.run_steps(w, [batch], seed, rcfg, templates, "cpu", ARCH, chunk=1)
    dr = ref_train.step_draws(seed, 0, 2, anchors, "cpu")
    noise = torch.stack([ref_train.kernel_noise(int(s), 10, 10, T, 4, "cpu") for s in dr["seeds"]])
    model = tiny_model(w)
    opt = make_optimizer(model, dataclasses.replace(detection_train_config(), lr=1e-2))
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    lb = train_step(model, opt, batch, None, cfg=cfg, templates=torch.tensor(templates, dtype=torch.float32),
                    lr=1e-2, draws={"noise": noise, "seeds": dr["seeds"], "uniforms": (dr["pos"], dr["neg"])})
    assert math.isclose(float(lb.total), ref["losses"][0], rel_tol=1e-5)
    for n, p in model.named_parameters():
        if n in ref["change"]:
            got = float((p.detach() - start[n]).norm())
            assert math.isclose(got, ref["change"][n], rel_tol=2e-3, abs_tol=1e-9), n


def detection_train_config():
    from tinyfaces_tpu_torch.config import TrainConfig

    return TrainConfig()


@pytest.mark.parametrize("q,k,rows", [(5, 5, 9), (3, 3, 9), (4, 6, 7)])
def test_get_rel_pos_interpolates_linearly(q, k, rows):
    table = torch.randn(rows, 4, generator=torch.Generator().manual_seed(rows))
    got = vitdet.get_rel_pos(q, k, table)
    assert torch.equal(got, R.get_rel_pos(q, k, table))
    n = 2 * max(q, k) - 1
    # F.interpolate "linear", align_corners False: output j samples (j + 0.5) * rows / n - 0.5
    src = np.clip((np.arange(n) + 0.5) * rows / n - 0.5, 0, rows - 1)
    resized = np.stack([np.interp(src, np.arange(rows), table[:, c].numpy()) for c in range(4)], 1)
    qc = np.arange(q)[:, None] * max(k / q, 1.0)
    kc = np.arange(k)[None, :] * max(q / k, 1.0)
    idx = (qc - kc + (k - 1) * max(q / k, 1.0)).astype(np.int64)
    np.testing.assert_allclose(got.numpy(), resized[idx], rtol=1e-5, atol=1e-6)


def test_reference_copies_equal():
    port = (ROOT / "tinyfaces_tpu_torch" / "models" / "vitdet_reference.py").read_bytes()
    assert port == (ROOT / "perfbench" / "reference" / "vitdet.py").read_bytes()


def test_published_shapes_and_counts():
    m = TinyFacesDetector(arch="vitdet_b")
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert shapes == R.param_shapes(R.VITDET_B, 25)
    assert sum(v.numel() for v in m.parameters()) == 88_611_914
    assert m.model.token_counts(8, 1024, 1024) == {"attn_tokens": 8 * (8 * 4900 + 4 * 4096),
                                                   "attn_pad_tokens": 8 * 8 * 804}
    cfg = detector_config("vitdet_b")
    assert (cfg.input_size, cfg.heatmap_size, cfg.rf.stride, cfg.rf.offset) == (
        (1024, 1024), (128, 128), (8, 8), (3.5, 3.5))


@pytest.mark.parametrize("arch", ["resnet101", "resnet50"])
def test_resnets_unchanged_by_the_registry(arch, monkeypatch):
    monkeypatch.setitem(detection.ARCHS, arch, dataclasses.replace(ARCHS[arch], stages=(1, 1, 1)))
    by_name = TinyFacesDetector(num_templates=T, arch=arch)
    by_stages = TinyFacesDetector(num_templates=T, stage_sizes=(1, 1, 1))
    assert list(by_name.state_dict()) == list(by_stages.state_dict())
    init_model(by_stages, torch.Generator().manual_seed(0))
    by_name.load_state_dict(by_stages.state_dict())
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(by_name.eval()(x), by_stages.eval()(x))
    assert detector_config(arch) == DetectorConfig()


def test_init_model_and_spans_and_counts(tiny_arch):
    model = init_model(TinyFacesDetector(num_templates=T, arch="vitdet_b"), torch.Generator().manual_seed(0))
    net = model.model.net
    assert float(net.blocks[0].attn.rel_pos_h.abs().max()) == 0.0  # ViTDet starts them at zero
    assert 0 < float(net.pos_embed.abs().max()) <= 0.04 and float(net.blocks[1].mlp.fc1.weight.abs().max()) <= 0.04
    assert float(net.blocks[1].norm1.weight.min()) == 1.0
    before = graphs.launch_counts("sdpa.")
    profiling.reset()
    profiling.enable()
    try:
        model(torch.zeros(2, 80, 80, 3))
    finally:
        profiling.enable(False)
    spans = [s for s in profiling.spans() if s.name.startswith("vit.")]
    assert [s.name for s in spans] == ["vit.embed"] + ["vit.block"] * 4 + ["vit.pyramid"]
    assert [(s.attrs["index"], s.attrs["kind"]) for s in spans[1:5]] == [
        (0, "window"), (1, "window"), (2, "global"), (3, "window")]
    after = graphs.launch_counts("sdpa.")
    assert after.get("sdpa.window.cpu", 0) - before.get("sdpa.window.cpu", 0) == 3
    assert after.get("sdpa.global.cpu", 0) - before.get("sdpa.global.cpu", 0) == 1
    # 5x5 tokens: windows of 3 pad to 6x6
    assert model.model.tokens == {"attn_tokens": 2 * (3 * 36 + 25), "attn_pad_tokens": 2 * 3 * 11}


@pytest.mark.parametrize("cell", [(3, 5), (10, 2)])
def test_receptive_field_geometry(cell):
    """A face with a template's exact size centred on the derived centre of
    cell (y, x), 8i + 3.5, gets its positive anchors at that cell only."""
    templates = torch.tensor([[-12.0, -15.0, 12.0, 15.0], [-30.0, -40.0, 30.0, 40.0]])
    cfg = detector_config("vitdet_b", num_templates=2, input_size=(128, 128), heatmap_size=(16, 16), max_gt=2)
    y, x = cell
    cy, cx = 8 * y + 3.5, 8 * x + 3.5
    box = torch.tensor([[cx - 12, cy - 15, cx + 12, cy + 15], [0, 0, 0, 0]], dtype=torch.float32)
    batch = {"image": torch.zeros(1, 128, 128, 3, dtype=torch.uint8), "gt_boxes": box[None],
             "gt_valid": torch.tensor([[True, False]]), "paste_box": torch.tensor([[0.0, 0.0, 128.0, 128.0]]),
             "flip": torch.tensor([False])}
    _, cls_maps, reg_maps = build_targets(batch, templates, torch.Generator().manual_seed(0), cfg)
    pos = torch.nonzero(cls_maps[0] == 1).tolist()
    assert pos == [[y, x, 0]]
    assert torch.allclose(reg_maps[0, y, x, [0, 2]], torch.zeros(2), atol=1e-6)  # template 0's tx, ty: centred


def test_eval_pyramid_refuses_vitdet(tiny_arch):
    with pytest.raises(ValueError, match="no pyramid support"):
        evaluation.get_model(arch="vitdet_b", device="cpu")
    model = TinyFacesDetector(num_templates=T, arch="vitdet_b")
    with pytest.raises(ValueError, match="no pyramid support"):
        evaluation.PyramidDetector(model, np.zeros((T, 5)), device="cpu")
    with pytest.raises(ValueError, match="stem_precomputed"):
        model(torch.zeros(1, 80, 80, 3), stem_precomputed=True)
    with pytest.raises(ValueError, match="remat"):
        TinyFacesDetector(arch="vitdet_b", remat=True)

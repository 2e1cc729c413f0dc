"""The ViTDet-B cell and the four-card driver: the frozen ViT FLOP count
against torch's FlopCounterMode over the reference on `meta`, the four new
readers on a fixture summary (SDPA's kernel names, a hand `*attn*` kernel
and NCCL's beside a convolution), the manifest's new cell, the ViT driver
at a tiny size on the CPU, and the data-parallel driver over two gloo ranks
on the CPU: a run to its result line, and a failing rank ending the run."""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness
from perfbench.counts import vitdet_flops
from perfbench.harness import HERE, load_module
from perfbench.reference import vitdet as ref_vit

ROOT = harness.ROOT
B = harness.manifest()
TINY = {"img_size": 128, "patch_size": 16, "embed_dim": 32, "depth": 4, "num_heads": 2, "mlp_dim": 64,
        "window_size": 3, "global_blocks": [2], "pretrain_grid": 7, "pyramid_dim": 16, "ln_eps": 1e-6}


def counted(arch, hw, train, templates):
    w = {k: torch.empty(s, device="meta", requires_grad=train and not k.startswith("score4_"))
         for k, s in ref_vit.param_shapes(arch, templates).items()}
    x = torch.empty(1, 3, *hw, device="meta")
    with FlopCounterMode(display=False) as c:
        if train:
            ref_vit.VitDet(w, arch).forward(x).sum().backward()
        else:
            with torch.no_grad():
                ref_vit.VitDet(w, arch).forward(x)
    return float(c.get_total_flops())


@pytest.mark.parametrize("hw,train", [((128, 128), False), ((128, 128), True), ((160, 112), True)])
def test_vit_count_equals_flop_counter(hw, train):
    f = vitdet_flops.train_flops if train else vitdet_flops.forward_flops
    assert f(hw, TINY, 3) == counted(TINY, hw, train, 3)


def test_published_vit_counts():
    a = ref_vit.VITDET_B
    assert vitdet_flops.train_flops((1024, 1024), a) == counted(a, (1024, 1024), True, 25)
    assert round(vitdet_flops.forward_flops((1024, 1024), a) / 1e12, 4) == 1.0056
    assert round(vitdet_flops.train_flops((1024, 1024), a) / 1e12, 4) == 3.0120
    assert round(vitdet_flops.attention_train((1024, 1024), a) / 1e12, 4) == 0.7040
    # by hand: a global block's scores and products with v, 12 heads of 64 over 4096 tokens
    assert vitdet_flops.attention_forward((1024, 1024), dict(a, depth=1, global_blocks=[0])) == \
        12 * (4 * 4096 * 4096 * 64 + 2 * 4096 * 64 * 128)


class FakeRun:
    def __init__(self, summary=None, e2e=None, counters=None):
        self.trace_summary, self.e2e, self.counters = summary, e2e or {}, counters or {}
        self.devices = [torch.device("cpu")]
        self.device = self.devices[0]


def read(name, run):
    return load_module(HERE / "metrics" / f"{name}.py").read(run)


KERNELS = {
    "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel<...>::Params)": (0.030, 40),
    "fmha_cutlassB_bf16_aligned_64x64_k64_sm80(PyTorchMemEffAttention::AttentionBackwardKernel<...>::Params)": (0.050, 40),
    "void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<64, 128> >(Flash_fwd_params)": (0.005, 4),
    "void (anonymous namespace)::rel_attn_bias_kernel<64>(float const*)": (0.005, 4),
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64": (0.200, 400),
    "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)": (0.025, 100),
}
SUMMARY = {"window_s": 0.5, "busy_s": 0.45, "kernels": {k: {"s": s, "n": n} for k, (s, n) in KERNELS.items()}}


def test_new_readers_on_fixture(monkeypatch):
    from perfbench.metrics import _read

    # the attention kernels: SDPA's two fmha kernels, a flash kernel and the hand *attn* kernel
    assert read("attn_ms.vitdet", FakeRun(SUMMARY, counters={"window_steps": 4})) == pytest.approx(1e3 * 0.09 / 4)
    assert read("comm_share.dp4", FakeRun(SUMMARY)) == pytest.approx(100 * 0.025 / 0.5)
    h100 = "NVIDIA H100 80GB HBM3"
    roof = load_module(HERE / "metrics" / "attn_roofline.vitdet.py")
    monkeypatch.setattr(roof, "device_kind", lambda run: h100)
    run = FakeRun(SUMMARY, counters={"window_steps": 4, "attn_flops_per_step": 5.0e12})
    assert roof.read(run) == pytest.approx(100 * 5.0e12 * 4 / 989e12 / 0.09)
    monkeypatch.setattr(_read, "device_kind", lambda run: h100)
    mfu = FakeRun(SUMMARY, e2e={"train_img_per_s": 30.0}, counters={"flops_per_item": 3.0e12})
    assert read("vitdet_train_mfu", mfu) == pytest.approx(100 * 3.0e12 * 30 / 989e12)
    empty = FakeRun({"window_s": 0.5, "busy_s": 0.1, "kernels": {}}, counters={"window_steps": 4})
    for name in ("attn_ms.vitdet", "comm_share.dp4"):
        assert read(name, empty) is None and read(name, FakeRun(None)) is None
    assert read("vitdet_train_mfu", FakeRun(SUMMARY)) is None  # no rate: nothing to read


def test_manifest_new_cells():
    cells = {w["name"]: w for w in B["workloads"]}
    v = cells["train-vitdet-b8-1024"]
    assert (v["traffic"], v["config"], v["chips"]) == ("wider-train-tree-1024", "tinyfaces-vitdet-b-train-bf16", 1)
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= max(1, len(B["workloads"]) // 4)
    for name in ("train_img_per_s", "device_step_ms.train", "device_idle.train"):
        m = next(x for x in B["end_to_end"] + B["per_layer"] if x["name"] == name)
        assert "train-vitdet-b8-1024" in m["workloads"]
    # the four-card cell's driver, mix and reader are built; no cell lists them yet (PERF.md)
    assert "train-wider-dp4" not in cells
    for path in ("drivers/train_dp.py", "traffic/wider-train-tree-dp4.json", "metrics/comm_share.dp4.py"):
        assert (ROOT / "perfbench" / path).is_file()
    conf = json.loads((ROOT / "perfbench/configs/tinyfaces-vitdet-b-train-bf16.json").read_text())
    assert conf["reduced"] == ["batch_size"] and conf["vit"] == dict(ref_vit.VITDET_B)
    assert conf["parameters"] == sum(math.prod(s) for s in ref_vit.param_shapes(ref_vit.VITDET_B).values())


def tiny_vit_cell(tmp_path):
    """The ViT cell's configuration and traffic at the tiny size."""
    from perfbench.run import load_cell

    _, cell, config, traffic = load_cell("train-vitdet-b8-1024")
    config = dict(config, batch_size=2, input_size=[128, 128], heatmap_size=[16, 16], max_gt=24,
                  reference_chunk=1, vit=TINY)
    traffic = dict(traffic, images=3, width=320, height=[240, 320], repeats=4, workers=2, face_px=[8, 60])
    return cell, config, traffic


def test_vit_driver_tiny_on_cpu(tmp_path, monkeypatch):
    from perfbench.run import execute
    from tinyfaces_tpu_torch.models import detection
    from tinyfaces_tpu_torch.models.vitdet import VitConfig, VitDetBackbone

    small = VitConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in TINY.items()})
    monkeypatch.setitem(detection.ARCHS, "vitdet_b", dataclasses.replace(
        detection.ARCHS["vitdet_b"], build=lambda s, d, r: VitDetBackbone(small, d), channels=(16, 16)))
    cell, config, traffic = tiny_vit_cell(tmp_path)
    run = harness.Run(cell["name"], config, traffic, seed=2**31 + 7, seconds=3.0, trace=False,
                      devices=[torch.device("cpu")], t_start=time.perf_counter(), tmpdir=tmp_path)
    line = execute(run, B, cell)
    assert line["metrics"]["train_img_per_s"]["value"] > 0 and "setup_s" in line["metrics"]
    assert set(line["checks"]) == {"aug_diff", "loss_gap", "update_gap", "change_gap", "window_gap"}
    assert line["checks"]["aug_diff"]["value"] == 0
    steps = run.counters["window_steps"]
    assert run.counters["attn.sdpa.global.cpu"] == steps and run.counters["attn.sdpa.window.cpu"] == 3 * steps
    assert run.counters["attn.attn_pad_tokens"] == 2 * 3 * (81 - 64)
    assert run.counters["k1_bound_s_per_call"] > 0


DP = """
import json, sys, time, torch
sys.path.insert(0, {root!r})
from perfbench import harness
from perfbench.run import execute
bench = harness.manifest()  # the cell as a later BENCHMARK.json would list it
cell = {{"name": "train-wider-dp4", "config": "tinyfaces-r101-train-fp32", "traffic": "wider-train-tree-dp4", "chips": 4}}
bench["workloads"].append(cell)
next(m for m in bench["end_to_end"] if m["name"] == "train_img_per_s")["workloads"].append(cell["name"])
config = json.loads((harness.ROOT / "perfbench/configs/tinyfaces-r101-train-fp32.json").read_text())
traffic = json.loads((harness.ROOT / "perfbench/traffic/wider-train-tree-dp4.json").read_text())
config = dict(config, stage_sizes=[1, 1, 1], batch_size=2, input_size=[128, 128], heatmap_size=[16, 16], max_gt=24)
traffic = dict(traffic, images=3, width=320, height=[240, 320], repeats=8, workers=2, face_px=[8, 60],
               timeout_s=60, ranks=2)
if {broken!r}:
    config["stage_sizes"] = "broken"  # rank 1 cannot build its model
run = harness.Run("train-wider-dp4", config, traffic, seed=2**31 + 9, seconds=2.0, trace=False,
                  devices=[torch.device("cpu")], t_start=time.perf_counter(), tmpdir={tmp!r})
print(json.dumps(execute(run, bench, cell)))
"""


@pytest.mark.parametrize("broken", [False, True])
def test_dp_driver_two_gloo_ranks(tmp_path, broken):
    """Two ranks on the CPU (gloo), each process one thread; the check's
    numbers are not compared here (the CPU's tie-break draws are not K1's).
    A rank that cannot start ends the run, failed, within its timeout."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", DP.format(root=str(ROOT), broken=broken, tmp=str(tmp_path))],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    if broken:
        assert out.returncode != 0 and time.monotonic() - t0 < 120, out.stderr[-2000:]
        return
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["metrics"]["train_img_per_s"]["value"] > 0 and line["attempted"] > 0
    assert line["checks"]["aug_diff"]["value"] == 0  # two ranks' rows are the global batch
    assert not list(tmp_path.glob("perfbench-dp-*"))  # the run's tree is gone

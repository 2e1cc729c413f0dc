"""The port's benches (tinyfaces_tpu_torch.bench, .bench_train) and the
model's `remat`, on the CPU at a tiny size.

* The benches' inputs are the root benches' (bench.natural_images,
  bench_train.make_synthetic_train_batch) bit for bit for the same seeds.
* Each bench's CLI ends with one JSON line of exactly the JAX contract's
  four keys on every wire it takes (the pyramid's four, the train step's
  three, whose yuv420 batches are the root bench's); `train_bench --multi`
  and every instrument's yuv420 and jpegdct4 wires get past its checks,
  and `--device cuda` without a card exits.
* `remat=True` gives one Trainer.train_step's loss, gradients, parameters
  and BN running statistics of `remat=False` (rtol 1e-6; on the CPU they
  are bit-equal); under a process group of two (collectives faked in one
  process) it issues the same all-reduces, in the same order; and it
  matches the JAX package's `TinyFacesDetector(remat=True)` step within
  tests/test_torch_trainer.py's tolerances.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
import bench_train as jax_bench_train
from tests.test_torch_native import jax_native_library  # noqa: F401
from tests.test_torch_trainer import CFG, TC, TINY_STAGES, _batch, _dataset, _step_draws
from tinyfaces_tpu.config import DetectorConfig as JaxDetectorConfig
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.trainer import create_train_state
from tinyfaces_tpu.trainer import make_optimizer as jax_make_optimizer
from tinyfaces_tpu.trainer import make_train_step as jax_make_train_step
from tinyfaces_tpu_torch import bench, bench_train
from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.parallel import distributed
from tinyfaces_tpu_torch.trainer import Trainer, make_lr_schedule, make_optimizer, train_step
from tinyfaces_tpu_torch.utils.convert import from_jax, to_jax
from tinyfaces_tpu_torch.utils.instruments import resolve_device

torch.set_num_threads(2)

TINY = dict(stage_sizes=(1, 1, 1))


@pytest.mark.parametrize("n,h,w,seed", [(2, 64, 96, 0), (1, 48, 80, 3)])
def test_natural_images_equal_the_root_bench(n, h, w, seed):
    got = bench.natural_images(n, h, w, seed=seed)
    want = jax_bench.natural_images(n, h, w, seed=seed)
    assert len(got) == n
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_train_batches_equal_the_root_bench(seed):
    cfg = DetectorConfig()
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(2):  # the second batch checks the draw order too
        got = bench_train.make_synthetic_train_batch(rng_a, 3, cfg)
        want = jax_bench_train.make_synthetic_train_batch(rng_b, 3, JaxDetectorConfig())
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _last_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


@pytest.mark.parametrize("transfer", ["jpegdct", "rgb", "yuv420", "jpegdct4"])
def test_bench_prints_the_contract_line(transfer, monkeypatch, capsys):
    for k, v in {"BENCH_TRANSFER": transfer, "BENCH_BATCH": "2", "BENCH_ITERS": "2",
                 "BENCH_WINDOWS": "2"}.items():
        monkeypatch.setenv(k, v)
    out = bench.main(["--device", "cpu"], hw=(64, 96), **TINY)
    line = _last_line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "pyramid_inference_images_per_sec_per_chip"
    assert line["unit"] == "images/sec/chip" and line["value"] > 0
    # both rounded from the unrounded rate (rounding the rounded value can differ)
    assert line["value"] == round(out["value"], 3)
    assert line["vs_baseline"] == round(out["value"] / 3.0, 3)
    assert len(out["window_rates"]) == 2 and out["flops_per_image"] > 0
    assert {"pack_ms", "enqueue_ms", "wait_ms", "total_ms"} <= set(out["batch1"])
    assert out["wire_Bpx"] == bench.wire_bytes_per_px(transfer, 64, 96)
    assert out["wire_Bpx"] == {"rgb": 3.0, "yuv420": 1.5}.get(transfer, out["wire_Bpx"])


@pytest.mark.parametrize("transfer", ["rgb", "jpegdct", "yuv420"])
def test_bench_train_prints_the_contract_line(transfer, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_TRANSFER", transfer)
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setattr(bench_train, "WINDOWS", 2)
    monkeypatch.setattr(bench_train, "STEPS_PER_WINDOW", 1)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", torch.backends.cudnn.allow_tf32)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", torch.backends.cuda.matmul.allow_tf32)
    out = bench_train.main(["--device", "cpu"], **TINY)
    line = _last_line(capsys)
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert line["metric"] == "train_step_images_per_sec_per_chip" and line["value"] > 0
    assert line["value"] == round(out["value"], 3)
    assert line["vs_baseline"] == round(out["value"] / 18.0, 3)
    assert out["steps"] == 2 and np.isfinite(out["last_loss"])
    assert out["k1_launches"] == 0  # the CPU takes K1's twin


@pytest.mark.parametrize("transfer", ["yuv420", "jpegdct4"])
def test_bench_item15_wires_exit(transfer, monkeypatch):
    """The wires ROADMAP item 15 held run now (test_bench_prints_the_
    contract_line); an unknown one exits."""
    assert transfer in bench.TRANSFERS
    monkeypatch.setenv("BENCH_TRANSFER", transfer[::-1])
    with pytest.raises(SystemExit, match="unknown transfer"):
        bench.main(["--device", "cpu"])


def test_bench_train_yuv420_exits(monkeypatch):
    """yuv420 runs (test_bench_train_prints_the_contract_line), its batches
    the root bench's bit for bit; an unknown wire exits."""
    rng_a, rng_b = np.random.default_rng(2), np.random.default_rng(2)
    got = bench_train.yuv420_pack(bench_train.make_synthetic_train_batch(rng_a, 2, DetectorConfig()))
    plain = jax_bench_train.make_synthetic_train_batch(rng_b, 2, JaxDetectorConfig())
    from tinyfaces_tpu.data.targets import rgb_to_yuv420

    y, u, v = rgb_to_yuv420(plain.pop("image"))
    want = {**plain, "image_y": y, "image_u": u, "image_v": v}
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    monkeypatch.setenv("BENCH_TRANSFER", "yuv422")
    with pytest.raises(SystemExit, match="unknown transfer"):
        bench_train.main(["--device", "cpu"])


@pytest.mark.parametrize("tool,argv", [
    ("train_bench", ["--multi", "4"]),
    ("jpegdct_ceiling", ["--transfer", "jpegdct4"]),
    ("serving_bench", ["--transfer", "yuv420"]),
    ("device_profile", ["--transfer", "yuv420"]),
    ("eval_sweep_bench", ["--transfer", "jpegdct4"]),
])
def test_tools_item15_choices_exit(tool, argv, monkeypatch):
    """The choices ROADMAP item 15 held (`train_bench --multi`, the wires)
    get past the tools' checks to the device (here a missing card); the
    multi step runs in tests/test_torch_multi_step.py."""
    import importlib

    mod = importlib.import_module(f"tinyfaces_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        mod.main(argv + ["--device", "cuda"])


def test_cuda_without_a_card_exits(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="is_available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


# --- remat -------------------------------------------------------------------

def _trainer_pair(seed=0):
    cfg = DetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=8)
    trainers = []
    base = init_model(TinyFacesDetector(stage_sizes=(1, 2, 1)), torch.Generator().manual_seed(seed))
    for remat in (False, True):
        model = TinyFacesDetector(stage_sizes=(1, 2, 1), remat=remat)
        model.load_state_dict(base.state_dict())
        t = Trainer(model=model, cfg=cfg, tc=TrainConfig(batch_size=2), templates=load_templates(),
                    device="cpu")
        t.setup(steps_per_epoch=10)
        trainers.append(t)
    return trainers


def test_remat_step_equals_plain_step():
    plain, remat = _trainer_pair()
    batch = _batch(_dataset(2, seed=4))
    losses = [t.train_step(batch) for t in (plain, remat)]
    for a, b in zip(*losses):
        np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    for (name, a), b in zip(plain.model.named_parameters(), remat.model.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=1e-6, atol=0, err_msg=name)
        if a.grad is not None:
            np.testing.assert_allclose(b.grad.numpy(), a.grad.numpy(), rtol=1e-6, atol=0, err_msg=name)
    for (name, a), b in zip(plain.model.named_buffers(), remat.model.buffers()):
        # a second BN update in the recompute would move every running statistic
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0, err_msg=name)


def test_remat_issues_the_plain_steps_all_reduces(monkeypatch):
    """World 2 in one process: the faked all-reduce adds a second rank
    holding the same rows, and records every call. With remat the
    recompute replays the gathered BN statistics: the same collectives in
    the same order, and the same gradients."""
    calls = []

    def fake_all_reduce(t, op=None):
        calls.append(tuple(t.shape))
        if t.dim() == 2 and t.shape[0] == 2:  # the BN rows: rank 1's row mirrors rank 0's
            t[1] = t[0]
        else:
            t.mul_(2.0)

    monkeypatch.setattr(distributed, "world", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 0)
    monkeypatch.setattr(distributed.dist, "all_reduce", fake_all_reduce)
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    grads, sequences, stats = [], [], []
    base = init_model(TinyFacesDetector(stage_sizes=(1, 2, 1)), torch.Generator().manual_seed(1))
    for remat in (False, True):
        model = TinyFacesDetector(stage_sizes=(1, 2, 1), remat=remat)
        model.load_state_dict(base.state_dict())
        model.train()
        calls.clear()
        (model(x) ** 2).mean().backward()
        sequences.append(list(calls))
        grads.append([p.grad.clone() for p in model.parameters() if p.grad is not None])
        stats.append([b.clone() for b in model.buffers()])
    assert len(sequences[0]) > 0 and sequences[1] == sequences[0]
    for a, b in zip(grads[0], grads[1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0)
    for a, b in zip(stats[0], stats[1]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0)


def test_remat_step_matches_jax_remat_step():
    """tests/test_torch_trainer.py's one-step check with remat on both
    sides (same tolerances)."""
    templates = load_templates()
    jmodel = JaxDetector(stage_sizes=TINY_STAGES, remat=True)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(0), CFG.input_size))
    tx = jax_make_optimizer(TC, steps_per_epoch=10)
    state = create_train_state(jmodel, params, stats, tx)
    items = _dataset(2, seed=1)
    key = jax.random.PRNGKey(5)
    jstate, jlb = jax_make_train_step(jmodel, tx, CFG, templates)(
        state, {k: jnp.asarray(np.stack([it[k] for it in items])) for k in items[0]}, key)

    model = TinyFacesDetector(stage_sizes=TINY_STAGES, remat=True)
    model.load_state_dict(from_jax(params, stats))
    opt = make_optimizer(model, TC)
    lb = train_step(model, opt, _batch(items), None, cfg=CFG,
                    templates=torch.tensor(templates, dtype=torch.float32),
                    lr=make_lr_schedule(TC, 10)(0), draws=_step_draws(key, 0, 2))
    for got, want in zip(lb, jlb):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    new_params, new_stats = to_jax(model.state_dict())
    want_params, want_stats = jax.device_get((jstate.params, jstate.batch_stats))
    scale = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(want_params))
    for a, b in zip(jax.tree_util.tree_leaves(new_params), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)
    for a, b in zip(jax.tree_util.tree_leaves(new_stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

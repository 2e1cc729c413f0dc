"""Multi-process training and sharded evaluation of the port on the CPU:
real worker processes (tests/torch_dist_worker.py) on gloo, their process
group formed through a `file://` store (no port is bound and released).

At stage_sizes (1, 1, 1), 64x64, max_gt 4, a global batch of 4 whose two
halves differ (dark rows on rank 0, bright rows on rank 1), one step at
world 2:
  * with the JAX step's draws (each rank takes its rows) gives the JAX
    package's 2-device data-parallel step within the tolerances of
    tests/test_torch_trainer.py (loss rtol 1e-4; parameters rtol 1e-4 and
    atol 1e-4 of the weight scale; BN statistics rtol 1e-4, atol 1e-5);
  * with the trainer's own draws is bit-equal across the ranks and within
    atol 5e-5 (parameters) and 1e-4 (BN statistics) of one process on the
    whole batch, as tests/test_parallel.py holds 8 devices to 1;
  * a variant that keeps each rank's own BatchNorm statistics updates the
    running statistics from its rows' var_mean and fails the BN check;
  * one BatchNorm2d on channels of mean 1000 and spread 0.1 gives one
    float64 process's output, input gradient and statistics, where flax's
    fast variance E[x^2] - E[x]^2 would cancel in float32.
At world 4 a run of 4 steps and a run of 2 steps, a checkpoint and 2 more
in fresh processes leave bit-equal parameters, momentum and buffers on
every rank. Through the training CLI, a SIGTERM to rank 1 alone stops both
ranks after the same epoch, with one checkpoint and one JSONL. The loaders'
rank slices partition each global batch; the CLIs refuse what cannot run;
the evaluation CLI's two coordinated ranks write disjoint halves of the
single process's tree; a detector split over two CPU replicas equals the
unsplit one.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_evaluate_cli import _tree as write_val_tree
from tests.test_torch_loss import jax_uniforms
from tests.test_torch_wider_train import TREE_FACES, TREE_SIZES, write_train_tree
from tinyfaces_tpu.config import DetectorConfig as JaxDetectorConfig
from tinyfaces_tpu.config import TrainConfig as JaxTrainConfig
from tinyfaces_tpu.models.detection import TinyFacesDetector as JaxDetector
from tinyfaces_tpu.models.detection import init_model as jax_init_model
from tinyfaces_tpu.parallel.mesh import make_mesh, replicate_tree, shard_batch
from tinyfaces_tpu.trainer import create_train_state
from tinyfaces_tpu.trainer import make_optimizer as jax_make_optimizer
from tinyfaces_tpu.trainer import make_train_step as jax_make_train_step
from tinyfaces_tpu_torch import evaluate_model
from tinyfaces_tpu_torch import main as train_cli
from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig, TrainConfig
from tinyfaces_tpu_torch.data import load_templates
from tinyfaces_tpu_torch.data import wider_face as wf
from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader, PrefetchLoader
from tinyfaces_tpu_torch.data.targets import normalize_images
from tinyfaces_tpu_torch.evaluation import PyramidDetector
from tinyfaces_tpu_torch.models import resnet
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.parallel import distributed, mesh
from tinyfaces_tpu_torch.trainer import Trainer, load_checkpoint
from tinyfaces_tpu_torch.utils.convert import from_jax, to_jax

ROOT = Path(__file__).resolve().parent.parent
WORKER = Path(__file__).resolve().parent / "torch_dist_worker.py"
CFG = DetectorConfig(input_size=(64, 64), heatmap_size=(8, 8), max_gt=4)
JAX_CFG = JaxDetectorConfig(input_size=(64, 64), heatmap_size=(8, 8), max_gt=4)
B = 4  # global batch: 2 rows per rank at world 2
STAGES = (1, 1, 1)

torch.set_num_threads(2)


def launch(mode: str, world: int, workdir: Path, *extra: str, timeout: int = 240) -> list[str]:
    """Runs `world` worker processes of `mode` (tests/torch_dist_worker.py)
    and returns their outputs; a worker's `{rank}` in `extra` becomes its
    rank. Fails on a non-zero exit or a worker still running at `timeout`."""
    workdir.mkdir(parents=True, exist_ok=True)
    store = workdir / f"store_{mode}_{len(list(workdir.glob('store_*')))}"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(WORKER), mode, f"file://{store}", str(world),
                               str(r), str(workdir), *(a.format(rank=r, store=store) for a in extra)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=workdir)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _batch(rng) -> dict:
    """A global batch whose rank-0 rows are dark and rank-1 rows bright, so
    the two ranks' BatchNorm statistics differ from the batch's."""
    lo = np.repeat([0, 150], B // 2)[:, None, None, None]
    image = (lo + rng.integers(0, 106, (B, *CFG.input_size, 3))).astype(np.uint8)
    gt = np.zeros((B, CFG.max_gt, 4), np.float32)
    n = rng.integers(1, CFG.max_gt + 1, B)
    for i in range(B):
        xy = rng.uniform(0, 30, (n[i], 2))
        gt[i, :n[i]] = np.concatenate([xy, xy + rng.uniform(8, 30, (n[i], 2))], 1)
    return {"image": image, "gt_boxes": gt, "gt_valid": np.arange(CFG.max_gt)[None] < n[:, None],
            "paste_box": np.tile(np.array([0, 0, 64, 64], np.float32), (B, 1)),
            "flip": rng.integers(0, 2, B).astype(bool)}


def _step_draws(key, b: int) -> dict:
    """The draws the JAX train step makes from `key` at step 0, for the
    global batch (tests/test_torch_trainer.py's, at this config)."""
    k_assign, k_sample = jax.random.split(jax.random.fold_in(key, 0))
    vsy, vsx = CFG.heatmap_size
    shape = (vsy, vsx, CFG.num_templates, CFG.max_gt)
    noise = np.stack([np.asarray(1e-6 * jax.random.uniform(k, shape))
                      for k in jax.random.split(k_assign, b)])
    return {"noise": torch.from_numpy(noise),
            "uniforms": jax_uniforms(k_sample, b, vsy * vsx * CFG.num_templates)}


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """The JAX 2-device step, world 1 of the port on the whole batch, and
    the two workers' results (see tests/torch_dist_worker.py mode step)."""
    work = tmp_path_factory.mktemp("step")
    batch = _batch(np.random.default_rng(1))
    jmodel = JaxDetector(stage_sizes=STAGES)
    params, stats = jax.device_get(jax_init_model(jmodel, jax.random.PRNGKey(0), CFG.input_size))
    key = jax.random.PRNGKey(5)
    draws = _step_draws(key, B)
    weights = from_jax(params, stats)
    bn_rng = np.random.default_rng(6)
    bn_x = torch.from_numpy((1000.0 + 0.1 * bn_rng.standard_normal((B, 3, 5, 7))).astype(np.float32))
    bn_g = torch.from_numpy(bn_rng.standard_normal((B, 3, 5, 7)).astype(np.float32))
    torch.save({"weights": weights, "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
                "draws": draws, "bn_x": bn_x, "bn_g": bn_g}, work / "inputs.pt")
    launched = launch("step", 2, work)

    tx = jax_make_optimizer(JaxTrainConfig(batch_size=B), steps_per_epoch=10)
    two = make_mesh(jax.devices()[:2])
    state = replicate_tree(create_train_state(jmodel, params, stats, tx), two)
    jstate, jlb = jax_make_train_step(jmodel, tx, JAX_CFG, load_templates())(
        state, shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, two), key)

    model = TinyFacesDetector(stage_sizes=STAGES)
    model.load_state_dict(weights)
    one = Trainer(model, CFG, TrainConfig(batch_size=B), load_templates(), device="cpu", seed=3,
                  augment="python")
    one.setup(steps_per_epoch=10)
    lb = one.train_step({k: torch.from_numpy(v) for k, v in batch.items()})
    return {"ranks": [torch.load(work / f"out_{r}.pt", weights_only=True) for r in range(2)],
            "jax": (jax.device_get((jstate.params, jstate.batch_stats)), [float(x) for x in jlb]),
            "world1": (one.model.state_dict(), [x.item() for x in lb]), "batch": batch,
            "weights": weights, "log": launched, "bn_x": bn_x, "bn_g": bn_g}


def test_world2_step_matches_jax_2_device_step(step):
    state, losses = step["ranks"][0]["injected"]
    (want_params, want_stats), want_losses = step["jax"]
    for got, want in zip(losses, want_losses):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    new_params, new_stats = to_jax(state)
    scale = max(np.abs(w).max() for w in jax.tree_util.tree_leaves(want_params))
    for a, b in zip(jax.tree_util.tree_leaves(new_params), jax.tree_util.tree_leaves(want_params)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * scale)
    for a, b in zip(jax.tree_util.tree_leaves(new_stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def test_world2_ranks_bit_equal_and_match_world1(step):
    for variant in ("injected", "own"):
        a, b = (step["ranks"][r][variant] for r in range(2))
        assert a[1] == b[1], variant  # the all-reduced losses
        for k, v in a[0].items():
            assert torch.equal(v, b[0][k]), (variant, k)
    state, losses = step["ranks"][0]["own"]
    want, want_losses = step["world1"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for k, v in state.items():
        atol = 1e-4 if k.endswith(("running_mean", "running_var")) else 5e-5
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=atol, err_msg=k)


def test_batch_norm_uses_global_statistics(step):
    """The stem's BatchNorm running statistics after one step: world 2
    holds them to world 1 (atol 1e-4); the local-statistics variant gives
    each rank 0.9 * init + 0.1 * var_mean of its own rows and fails that
    check."""
    want = step["world1"][0]
    model = TinyFacesDetector(stage_sizes=STAGES)
    model.load_state_dict(step["weights"])
    for r in range(2):
        rows = slice(r * B // 2, (r + 1) * B // 2)
        images = normalize_images(torch.from_numpy(step["batch"]["image"][rows]))
        with torch.no_grad():
            stem = model.model.conv1(images.permute(0, 3, 1, 2))
        var, mean = torch.var_mean(stem, dim=(0, 2, 3), correction=0)
        local = step["ranks"][r]["local_bn"][0]
        global_ = step["ranks"][r]["own"][0]
        for name, init, stat in (("running_mean", 0.0, mean), ("running_var", 1.0, var)):
            key = f"model.bn1.{name}"
            np.testing.assert_allclose(local[key].numpy(), (0.9 * init + 0.1 * stat).numpy(),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(global_[key].numpy(), want[key].numpy(), rtol=0, atol=1e-4)
            assert np.abs(local[key].numpy() - want[key].numpy()).max() > 1e-2, (r, key)


def test_batch_norm_merge_is_stable_where_the_fast_variance_cancels(step):
    """Channels of mean 1000 and spread 0.1: E[x^2] - E[x]^2 in float32
    loses the variance (one ulp of 1e6 is 0.06), the merge of the ranks'
    two-pass statistics keeps it. Each rank's output, input gradient and
    running statistics against one float64 process on the whole batch."""
    x = step["bn_x"].double().requires_grad_(True)
    bn = resnet.BatchNorm2d(x.shape[1]).double().train()
    y = bn(x)
    (y * step["bn_g"].double()).sum().backward()
    for r in range(2):
        got, rows = step["ranks"][r]["bn"], slice(r * B // 2, (r + 1) * B // 2)
        np.testing.assert_allclose(got["y"].numpy(), y[rows].detach().numpy(), rtol=0, atol=2e-3)
        np.testing.assert_allclose(got["grad"].numpy(), x.grad[rows].numpy(), rtol=0, atol=2e-2)
        np.testing.assert_allclose(got["running_mean"].numpy(), bn.running_mean.numpy(), rtol=1e-6)
        np.testing.assert_allclose(got["running_var"].numpy(), bn.running_var.numpy(), rtol=1e-4)


def test_world4_resume_seam_is_bit_exact(tmp_path):
    digests = {}
    for phase in ("full", "part1", "part2"):
        for out in launch("resume", 4, tmp_path, phase):
            for line in out.splitlines():
                if line.startswith("DIGEST"):
                    _, rank, ph, value = line.split()
                    digests[(ph.split("=")[1], int(rank.split("=")[1]))] = value
    assert (tmp_path / "ckpt").is_file()
    assert load_checkpoint(tmp_path / "ckpt")["step"] == 2
    full = {digests[("full", r)] for r in range(4)}
    resumed = {digests[("part2", r)] for r in range(4)}
    assert len(full) == 1 and resumed == full, digests


def test_sigterm_to_one_rank_stops_every_rank_at_the_same_epoch(tmp_path):
    tree = write_train_tree(tmp_path / "data")  # 5 images: 2 steps of 2 per epoch
    argv = [str(tree), str(tree), "--dataset-root", str(tree.parent), "--device", "cpu",
            "--arch", "resnet50", "--batch_size", "2", "--workers", "1", "--max-gt", "8",
            "--seed", "3", "--epochs", "3", "--metrics-log", "metrics.jsonl",
            "--num-processes", "2", "--process-id", "{rank}",
            "--coordinator-address", "file://{store}", "--sigterm-rank", "1"]
    outs = launch("train", 2, tmp_path / "run", *argv)
    for r, out in enumerate(outs):
        assert f"STOPPED rank={r} step=2" in out, out[-2000:]  # epoch 0 done, no more
    assert "will checkpoint and stop" in outs[1] and "will checkpoint" not in outs[0]
    weights = tmp_path / "run" / "weights"
    assert sorted(p.name for p in weights.iterdir()) == ["checkpoint_1"]
    assert load_checkpoint(weights / "checkpoint_1")["epoch"] == 1
    records = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(records) == 3  # rank 0's two steps and its epoch_end, once
    assert "Epoch: [0][1/2]" in outs[0] and "Epoch: [0]" not in outs[1]


@pytest.mark.parametrize("loader", [PrefetchLoader, NativePrefetchLoader])
@pytest.mark.parametrize("pack", ["rgb", "jpegdct"])
def test_loader_rank_slices_partition_the_global_batch(tmp_path, loader, pack):
    cfg = DetectorConfig(input_size=(128, 128), heatmap_size=(16, 16), max_gt=8)
    ann = write_train_tree(tmp_path, sizes=TREE_SIZES + TREE_SIZES[:3], faces=TREE_FACES + TREE_FACES[:3])
    ds = wf.WIDERFace(ann, load_templates(), cfg=cfg, dataset_root=tmp_path)

    def batches(**kw):
        return list(loader(ds, 4, device="cpu", workers=2, seed=3, epoch=1, pack=pack, **kw))

    full = batches()
    assert len(full) == 2
    for world in (2, 4):
        parts = [batches(rank=r, world=world) for r in range(world)]
        for b, want in enumerate(full):
            for k, v in want.items():
                got = torch.cat([parts[r][b][k] for r in range(world)])
                assert torch.equal(got, v), (world, b, k)


def test_loader_refuses_uneven_rank_slices():
    with pytest.raises(ValueError, match="divisible"):
        PrefetchLoader([], 6, device="cpu", rank=0, world=4)
    # the trailing partial batch (10 = 2 * 4 + 2) is dropped on every rank alike
    data = [{"v": np.full((2,), i)} for i in range(10)]
    for r in range(2):
        got = [b["v"] for b in PrefetchLoader(data, 4, device="cpu", workers=1, rank=r, world=2)]
        assert [len(v) for v in got] == [2, 2]


@pytest.mark.parametrize("device,cards,world", [("cuda", 1, 2), ("cuda:0", 2, 2), ("cuda", 2, 4)])
def test_train_cli_refuses_two_nccl_ranks_on_one_card(tmp_path, monkeypatch, device, cards, world):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    argv = ["t.txt", "v.txt", "--device", device, "--num-processes", str(world),
            "--coordinator-address", f"file://{tmp_path / 'store'}", "--batch_size", "4"]
    with pytest.raises(SystemExit, match="NCCL refuses two ranks on one card"):
        train_cli.run(train_cli.arguments(argv))
    assert not (tmp_path / "store").exists()  # refused before a group was formed


def test_train_cli_refuses_a_batch_that_does_not_divide(tmp_path):
    argv = ["t.txt", "v.txt", "--device", "cpu", "--num-processes", "4", "--batch_size", "6",
            "--coordinator-address", f"file://{tmp_path / 'store'}"]
    with pytest.raises(SystemExit, match="global batch"):
        train_cli.run(train_cli.arguments(argv))


def test_eval_cli_refuses_data_parallel_batch_that_does_not_divide(tmp_path, monkeypatch):
    monkeypatch.setattr(evaluate_model, "local_devices", lambda device: [torch.device("cpu")] * 2)
    with pytest.raises(SystemExit, match="divisible by the 2 devices"):
        evaluate_model.main(["ann.txt", "--device", "cpu", "--data-parallel", "--eval-batch", "3"])


def test_eval_two_coordinated_processes_write_disjoint_halves(tmp_path):
    """Both sweeps run in worker processes (one thread each) and detect one
    image at a time, so an image's result does not depend on its
    batchmates or on the thread count."""
    ann = write_val_tree(tmp_path)
    common = [str(ann), "--dataset-root", str(tmp_path), "--device", "cpu", "--fp32",
              "--arch", "resnet50", "--eval-batch", "1", "--workers", "1"]
    launch("eval", 1, tmp_path / "one", *common, "--results_dir", str(tmp_path / "single"))
    outs = launch("eval", 2, tmp_path / "run", *common, "--results_dir", str(tmp_path / "rank{rank}"),
                  "--num-processes", "2", "--process-id", "{rank}",
                  "--coordinator-address", "file://{store}")
    assert all("EVAL_OK" in out for out in outs)
    tree = lambda d: {p.relative_to(d): p.read_bytes() for p in d.rglob("*.txt")}  # noqa: E731
    single, halves = tree(tmp_path / "single"), [tree(tmp_path / f"rank{r}") for r in range(2)]
    assert len(single) == 7 and not set(halves[0]) & set(halves[1])
    assert {**halves[0], **halves[1]} == single
    assert sorted(len(h) for h in halves) == [3, 4]  # images r::2


def test_data_parallel_detector_equals_the_unsplit_one(tmp_path):
    model = init_model(TinyFacesDetector(stage_sizes=STAGES), torch.Generator().manual_seed(2))
    ec = EvalConfig(scales=(-1, 0, 1), max_dets_per_scale=50, max_total_dets=50)
    one = PyramidDetector(model, load_templates(), ec=ec, device="cpu")
    two = PyramidDetector(model, load_templates(), ec=ec, device=["cpu", "cpu"])
    assert two.devices == [torch.device("cpu")] * 2 and two.replicas[1].model is not model
    rng = np.random.default_rng(4)
    images = [rng.integers(0, 256, (90, 120, 3), dtype=np.uint8) for _ in range(4)]
    want = [one.detect_batch(images[i:i + 2], 0.2) for i in (0, 2)]
    got = two.detect_batch(images, 0.2)
    assert sum(len(d) for d in got) > 0
    for g, w in zip(got, want[0] + want[1]):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="does not split over 2"):
        two.detect_batch(images[:3])


def test_mesh_devices_and_split():
    assert mesh.rank_device("cpu", 3) == torch.device("cpu")
    assert mesh.rank_device("cuda:1", 5) == torch.device("cuda", 1)
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    assert mesh.split_batch(list(range(6)), 3) == [[0, 1], [2, 3], [4, 5]]
    with pytest.raises(ValueError, match="does not split"):
        mesh.split_batch(list(range(7)), 3)
    for shard in mesh.SHARD_MODES:  # spatial: tests/test_torch_spatial.py
        mesh.check_shard(shard)
    with pytest.raises(ValueError, match="unknown shard mode"):
        mesh.check_shard("rows")


def test_rank_device_wraps_over_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [mesh.rank_device("cuda", r) for r in (0, 5)] == [torch.device("cuda", 0),
                                                            torch.device("cuda", 1)]
    assert mesh.local_devices("cuda") == [torch.device("cuda", i) for i in range(4)]


def test_single_process_is_a_no_op():
    distributed.initialize()
    distributed.initialize(None, 1, 0)
    assert (distributed.rank(), distributed.world()) == (0, 1)
    assert distributed.process_batch_slice(24) == slice(0, 24)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(None, 2, 0)
    with distributed.GracefulStop() as stop:
        assert not stop.requested() and not stop.agreed()
        stop._handler(15, None)
        assert stop.requested() and stop.agreed()

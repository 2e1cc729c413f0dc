"""The train loop of drivers/train.py for ViTDet-B under the Tiny Faces head
(`main.py --arch vitdet_b --bf16`): `NativePrefetchLoader` (PIL decode, the
C++ engine's x0.5/x1/x2 resize, the 1024x1024 crop pasted on the mean
canvas, the flip, the GT filter and the `max_gt` cap) feeding
`Trainer.train_step` on `TinyFacesDetector(arch="vitdet_b")` (targets with
kernel K1 on the 128x128x25 anchors, the model in bfloat16 over float32
parameters, the loss, SGD), the loss read every step. On one card the
step is a replay of its captured CUDA graph, as every single-card step is.

The port's model is built first, before the tree: a port that has no such
architecture fails within seconds. Set-up, the window and the check follow
drivers/train.py, whose helpers this module takes: three set-up steps
(which warm every shape and capture the step), then the window; the
reference (reference/vitdet_train.py, float32, TF32 off, each batch in
chunks of `reference_chunk` images) redoes the loader's four batches from
the files and follows the four steps from the seeded weights
(reference/vitdet.make_weights).

Counters for the readers: the window's steps, K1's bound a call
(counts/bounds.k1_bound_s over the valid ground truths of the window's
batches, their mean, as drivers/train.py counts it), the frozen FLOPs of one
image's step (counts/vitdet_flops.train_flops) and of a step's attention
(attention_train times the batch), the peak memory, and the port's
attention counters where it has them (`attn.<name>`: its calls by kind and
backend in the window, replays included, and a forward's tokens).
"""

from __future__ import annotations

import gc
import math
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import harness
from perfbench.counts import bounds, vitdet_flops
from perfbench.drivers._shared import rng
from perfbench.drivers.train import CHECK_STEPS, change_norms, next_batch, reference_cfg, set_up_steps, trainable
from perfbench.reference import augment as ref_augment
from perfbench.reference import train as ref_train
from perfbench.reference import vitdet as ref_vit
from perfbench.reference import vitdet_train as ref_vtrain
from perfbench.traffic import generate


def attention_counts() -> dict:
    """The port's attention launches by kind and backend (none where the
    port does not count them)."""
    from tinyfaces_tpu_torch.utils import graphs

    read = getattr(graphs, "launch_counts", None)
    return read("sdpa.") if read else {}


def log_loader(run: harness.Run) -> None:
    """In a traced run, the loader's starved share of its gets (the reader
    of `loader_starved_pct.train`, which these cells do not list)."""
    if run.trace:
        read = harness.load_module(harness.HERE / "metrics" / "loader_starved_pct.train.py").read
        run.log(f"loader: {read(run)} % of the window's gets found no batch ready")


def build(run: harness.Run, root: Path) -> dict:
    """The model, the tree, the weights, the dataset, the Trainer and its loader."""
    from tinyfaces_tpu_torch.config import DetectorConfig, ReceptiveField, TrainConfig
    from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader
    from tinyfaces_tpu_torch.data.wider_face import WIDERFace
    from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
    from tinyfaces_tpu_torch.trainer import Trainer

    c, t = run.config, run.traffic
    # first: a port without this architecture raises here, within seconds
    model = TinyFacesDetector(num_templates=len(c["templates"]), arch=c["arch"], dtype=getattr(torch, c["dtype"]))
    t0 = time.perf_counter()
    ann, summary = generate.wider_tree(rng(run.seed, 5), root, t)
    t1 = time.perf_counter()
    templates = np.asarray(c["templates"], np.float64)
    weights = ref_vit.make_weights(run.seed, run.device, c["vit"], len(templates))
    if not c["tf32"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rf = ReceptiveField(size=(c["rf_size"],) * 2, stride=(c["rf_stride"],) * 2,
                        offset=(c["rf_offset"],) * 2)
    cfg = DetectorConfig(num_templates=len(templates), input_size=tuple(c["input_size"]),
                         heatmap_size=tuple(c["heatmap_size"]), pos_thresh=c["pos_thresh"],
                         neg_thresh=c["neg_thresh"], pos_fraction=c["pos_fraction"],
                         sample_size=c["sample_size"], hard_neg_loss_thresh=c["hard_neg_thresh"],
                         max_gt=c["max_gt"], rf=rf)
    tc = TrainConfig(lr=c["lr"], momentum=c["momentum"], weight_decay=c["weight_decay"],
                     batch_size=c["batch_size"], workers=t["workers"])
    dataset = WIDERFace(ann, templates, cfg=cfg, dataset_root=root, split="train")
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    seed = run.seed % 2**63
    trainer = Trainer(model=model, cfg=cfg, tc=tc, templates=templates, device=run.device,
                      seed=seed, augment="native", transfer=c["wire"])
    trainer.setup(max(1, len(dataset) // tc.batch_size))
    loader = NativePrefetchLoader(dataset, tc.batch_size, device=run.device, workers=t["workers"],
                                  seed=seed, epoch=0, pack=c["wire"])
    run.log(f"set-up: train tree {summary} in {t1 - t0:.2f} s")
    return {"weights": weights, "trainer": trainer, "loader": loader, "batches": iter(loader),
            "templates": templates, "seed": seed, "dataset": dataset, "ann": ann}


def check(run, env: dict, root: Path, prog: dict, kept: list) -> tuple:
    """(numbers, the reference's steps, its batches), as drivers/train.check."""
    c = run.config
    ref_batches = ref_augment.batches(root, env["ann"], env["seed"], c["batch_size"], len(kept),
                                      tuple(c["input_size"]), c["neg_thresh"], c["max_gt"])
    diff = ref_augment.aug_diff(kept, ref_batches)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref = ref_vtrain.run_steps(env["weights"], ref_batches, env["seed"], reference_cfg(c), env["templates"],
                                   run.device, c["vit"], chunk=c["reference_chunk"], change_at=CHECK_STEPS)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return dict(ref_train.numbers(prog, ref), aug_diff=diff), ref, ref_batches


def release(env: dict) -> None:
    """Free the port's state before the reference runs."""
    env["batches"].close()
    for k in ("trainer", "loader", "batches", "dataset"):
        env.pop(k, None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(run: harness.Run) -> None:
    root = Path(tempfile.mkdtemp(prefix="perfbench-vitdet-", dir=run.tmpdir))
    try:
        _run(run, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(run: harness.Run, root: Path) -> None:
    c = run.config
    env = build(run, root)
    trainer = env["trainer"]
    prog, kept, batch = set_up_steps(run, env)
    params = trainable(trainer)
    before = {n: p.detach().clone() for n, p in params.items()}
    after = {n: torch.empty_like(p) for n, p in params.items()}
    first_loss = None
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.spans.durations.clear()
    attn0 = attention_counts()
    valid = []
    t0 = run.begin_window()
    deadline = run.deadline()
    steps, t_last = 0, t0
    while True:
        if time.perf_counter() >= deadline:
            break
        with run.spans("train_step"):
            lb = trainer.train_step(batch)
        if first_loss is None:  # the window's first step, kept for the check
            torch._foreach_copy_(list(after.values()), list(params.values()))
            first_loss = lb.total
        valid.append(batch["gt_valid"])
        run.attempted += 1
        batch = next_batch(run, env)
        with run.spans("loss_read"):
            total = float(lb.total)
            float(lb.class_loss), float(lb.reg_loss)
        now = time.perf_counter()
        if now <= deadline:
            steps += 1
            t_last = now
            if not math.isfinite(total):
                run.failed += 1
    run.end_window()
    run.counters["memory_peak_bytes"] = harness.memory_peak(run.devices)
    b = c["batch_size"]
    if not steps:
        raise RuntimeError("no step completed within the window")
    run.e2e["train_img_per_s"] = steps * b / (t_last - t0)
    vsy, vsx = c["heatmap_size"]
    nt = len(env["templates"])
    counts = [int(v.bool().sum()) for v in valid]
    run.counters["k1_bound_s_per_call"] = float(np.mean(
        [bounds.k1_bound_s(n, b, c["max_gt"], vsy * vsx * nt, nt) for n in counts]))
    hw = tuple(c["input_size"])
    run.counters["flops_per_item"] = vitdet_flops.train_flops(hw, c["vit"], len(env["templates"]))
    run.counters["attn_flops_per_step"] = b * vitdet_flops.attention_train(hw, c["vit"])
    run.counters["window_steps"] = run.attempted
    log_loader(run)
    attn1 = attention_counts()
    for k, n in attn1.items():
        run.counters[f"attn.{k}"] = n - attn0.get(k, 0)
    tokens = getattr(trainer.model.model, "tokens", None) or {}
    run.counters.update({f"attn.{k}": v for k, v in tokens.items()})
    run.log(f"window: {steps} steps of {b} in {t_last - t0:.3f} s, {run.e2e['train_img_per_s']:.4f} img/s; "
            f"step counts {dict(trainer.step_counts)}; attention {[(k, v) for k, v in run.counters.items() if k.startswith('attn.')]}; "
            f"peak {run.counters['memory_peak_bytes']} B; "
            + ", ".join(f"{k} {1e3 * np.mean(v):.2f} ms (max {1e3 * max(v):.2f}; medians by thirds "
                        + "/".join(f"{1e3 * np.median(x):.2f}" for x in np.array_split(v, 3) if len(x)) + ")"
                        for k, v in run.spans.durations.items() if v))
    prog["losses"].append(float(first_loss))
    prog["window"] = change_norms(after, before)
    del trainer, params, before, after, lb, batch, valid
    release(env)
    t1 = time.perf_counter()
    nums, ref, _ = check(run, env, root, prog, kept)
    for k in ("aug_diff", "loss_gap", "update_gap", "change_gap", "window_gap"):
        run.checks.append((k, nums[k], c["limits"][k]))
    run.log(f"reference check of {len(kept)} steps: {time.perf_counter() - t1:.2f} s; "
            f"losses program {prog['losses']} reference {ref['losses']}; "
            f"change_gap_worst {nums['change_gap_worst']:.6g} window_loss_gap {nums['window_loss_gap']:.6g}")

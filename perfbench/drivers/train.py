"""The training loop `main.py` users run: `NativePrefetchLoader` (worker
threads decode each JPEG with PIL and augment it in the C++ engine: the
random x0.5/x1/x2 resize, the 500x500 crop pasted on the mean canvas, the
flip, the GT filter and the `max_gt` cap) feeding `Trainer.train_step`
(targets with kernel K1, the model, the loss, SGD), the loss read every
step as `Trainer.train_epoch` reads it at the CLI's `--log-every 1`.

Set-up builds the one Trainer, runs its first three steps through the
window's own loader and call (they also warm every shape), and keeps what
the check needs: those batches, the losses, each leaf's norm of the first
update (momentum after one step) and of its change after three. The same
Trainer then runs the window; the parameters before the window's first
step are copied in set-up, those after it into buffers set up beforehand
(one copy on the card inside the window, no read), and that step's batch
and loss are kept too.

The check, once the window has closed: the reference redoes the loader's
four batches from the tree's files (reference/augment.py) and counts the
values that differ (`aug_diff`), then follows the four steps on its own
batches from the seeded weights (reference/train.py).

`train_img_per_s`: the images of the steps whose loss was read within the
window over the time from its start to the last of those reads.
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
from perfbench import weights as W
from perfbench.counts import bounds, flops
from perfbench.drivers._shared import rng
from perfbench.reference import augment as ref_augment
from perfbench.reference import train as ref_train
from perfbench.traffic import generate

CHECK_STEPS = 3


def build(run: harness.Run, root: Path) -> dict:
    """The tree, the weights, the dataset, the Trainer and its loader."""
    from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig
    from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader
    from tinyfaces_tpu_torch.data.wider_face import WIDERFace
    from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
    from tinyfaces_tpu_torch.trainer import Trainer

    c, t = run.config, run.traffic
    t0 = time.perf_counter()
    ann, summary = generate.wider_tree(rng(run.seed, 5), root, t)
    t1 = time.perf_counter()
    stages = tuple(c["stage_sizes"])
    templates = np.asarray(c["templates"], np.float64)
    weights = W.make(run.seed, run.device, stages, len(templates))
    if not c["tf32"]:  # fp32 means fp32, as main.py sets it
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = DetectorConfig(num_templates=len(templates), input_size=tuple(c["input_size"]),
                         heatmap_size=tuple(c["heatmap_size"]), pos_thresh=c["pos_thresh"],
                         neg_thresh=c["neg_thresh"], pos_fraction=c["pos_fraction"],
                         sample_size=c["sample_size"], hard_neg_loss_thresh=c["hard_neg_thresh"],
                         max_gt=c["max_gt"])
    tc = TrainConfig(lr=c["lr"], momentum=c["momentum"], weight_decay=c["weight_decay"],
                     batch_size=c["batch_size"], workers=t["workers"])
    dataset = WIDERFace(ann, templates, cfg=cfg, dataset_root=root, split="train")
    model = TinyFacesDetector(num_templates=len(templates), stage_sizes=stages, dtype=None)
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    seed = run.seed % 2**63
    trainer = Trainer(model=model, cfg=cfg, tc=tc, templates=templates, device=run.device,
                      seed=seed, augment="native", transfer=c["wire"])
    trainer.setup(max(1, len(dataset) // tc.batch_size))
    loader = NativePrefetchLoader(dataset, tc.batch_size, device=run.device, workers=t["workers"],
                                  seed=seed, epoch=0, pack=c["wire"])
    run.log(f"set-up: train tree {summary} in {t1 - t0:.2f} s")
    return {"weights": weights, "trainer": trainer, "loader": loader, "batches": iter(loader),
            "stages": stages, "templates": templates, "seed": seed, "dataset": dataset, "ann": ann}


def trainable(trainer) -> dict:
    return {n: p for n, p in trainer.model.named_parameters() if p.requires_grad}


def update_norms(trainer) -> dict:
    """Each leaf's momentum norm (a step that never ran has none: 0)."""
    out = {}
    for name, p in trainable(trainer).items():
        buf = trainer.opt.state.get(p, {}).get("momentum_buffer")
        out[name] = 0.0 if buf is None else float(buf.norm())
    return out


def change_norms(after: dict, before: dict) -> dict:
    return {n: float((after[n].detach() - before[n]).norm()) for n in before}


def set_up_steps(run, env) -> tuple:
    """The Trainer's first CHECK_STEPS steps through the loader and the
    window's own call. Returns what the check reads of them, copies of
    their batches and of the next one, and that next batch."""
    trainer = env["trainer"]
    start = {n: p.detach().clone() for n, p in trainable(trainer).items()}
    prog, kept = {"losses": []}, []
    batch = next_batch(run, env)
    for s in range(CHECK_STEPS):
        kept.append({k: v.clone() for k, v in batch.items()})
        lb = trainer.train_step(batch)
        batch = next_batch(run, env)
        prog["losses"].append(float(lb.total))
        if s == 0:
            prog["update"] = update_norms(trainer)
    prog["change"] = change_norms(trainable(trainer), start)
    kept.append({k: v.clone() for k, v in batch.items()})
    return prog, kept, batch


def check(run, env: dict, root: Path, prog: dict, kept: list) -> tuple:
    """(numbers, the reference's steps, its batches): the loader's batches
    against the reference's from the tree's files, and the program's steps
    against the reference's on those. Call once the program's state is
    gone."""
    c = run.config
    ref_batches = ref_augment.batches(root, env["ann"], env["seed"], c["batch_size"], len(kept),
                                      tuple(c["input_size"]), c["neg_thresh"], c["max_gt"])
    diff = ref_augment.aug_diff(kept, ref_batches)
    ref = ref_train.run_steps(env["weights"], ref_batches, env["seed"], reference_cfg(c), env["templates"],
                              run.device, env["stages"], change_at=CHECK_STEPS)
    return dict(ref_train.numbers(prog, ref), aug_diff=diff), ref, ref_batches


def next_batch(run, env):
    with run.spans("loader_next"):
        try:
            return next(env["batches"])
        except StopIteration:  # a new epoch: the loader's own next pass
            env["batches"] = iter(env["loader"])
            return next(env["batches"])


def run(run: harness.Run) -> None:
    root = Path(tempfile.mkdtemp(prefix="perfbench-train-", dir=run.tmpdir))
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
    counts = [int((v.bool()).sum()) for v in valid]
    run.counters["k1_bound_s_per_call"] = float(np.mean(
        [bounds.k1_bound_s(n, b, c["max_gt"], vsy * vsx * nt, nt) for n in counts]))
    run.counters["flops_per_item"] = flops.train_flops(tuple(c["input_size"]), env["stages"], nt)
    run.counters["chips"] = len(run.devices)
    run.counters["window_steps"] = run.attempted  # each ran whole inside the window (its loss read)
    run.log(f"window: {steps} steps of {b} in {t_last - t0:.3f} s, "
            f"{run.e2e['train_img_per_s']:.4f} img/s; valid GTs a batch mean {np.mean(counts):.1f}; "
            + ", ".join(f"{k} {1e3 * np.mean(v):.2f} ms (max {1e3 * max(v):.2f}; medians by thirds "
                        + "/".join(f"{1e3 * np.median(x):.2f}" for x in np.array_split(v, 3) if len(x)) + ")"
                        for k, v in run.spans.durations.items() if v))
    prog["losses"].append(float(first_loss))
    prog["window"] = change_norms(after, before)
    env["batches"].close()
    for k in ("trainer", "loader", "batches", "dataset"):
        del env[k]
    del trainer, params, before, after, lb, batch, valid
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    nums, ref, _ = check(run, env, root, prog, kept)
    for k in ("aug_diff", "loss_gap", "update_gap", "change_gap", "window_gap"):
        run.checks.append((k, nums[k], c["limits"][k]))
    run.log(f"reference check of {len(kept)} steps: {time.perf_counter() - t1:.2f} s; "
            f"losses program {prog['losses']} reference {ref['losses']}")


def reference_cfg(c: dict) -> dict:
    keys = ("heatmap_size", "rf_stride", "rf_offset", "pos_thresh", "neg_thresh", "hard_neg_thresh",
            "sample_size", "pos_fraction", "weight_decay", "momentum", "lr")
    return {**{k: c[k] for k in keys}, "num_templates": len(c["templates"])}

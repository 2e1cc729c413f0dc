"""Training runtime: optimizer, train step, epoch loop, checkpoints.

Port of tinyfaces_tpu/trainer.py (reference trainer.py:68-90, main.py:66-104)
for one device:
  * SGD(momentum 0.9, weight decay 5e-4) with per-group learning rates —
    backbone 1x, score_res3 0.1x, score_res4 1x; the bilinear upsampler is
    frozen (requires_grad=False, in no group, so it gets no decay either).
    torch's SGD applies decay, then momentum, then lr, as the JAX optax
    chain does;
  * StepLR (x0.1 every 20 epochs) as a per-step staircase;
  * the reference console line "Epoch: [e][i/n]  loss_cls ... loss_reg ...";
  * checkpoints of {model, optimizer, step, epoch, batch_size} via torch.save,
    snapshotted to host memory and written atomically, on a background
    thread when asked (`block=False`, then `wait_for_checkpoints()`);
  * the epoch loop over WIDER data: the C++ augmentation engine
    (`augment="native"`, the CLI's) or the dataset's own Python
    augmentation (`augment="python"`), the GT-truncation line of the epoch
    log, and the JAX package's JSONL metrics records (`metrics_path`).

Each step's randomness comes from a generator seeded with (seed, step), and
each epoch's shuffle and augmentation from (seed, epoch), so a resumed run
draws exactly what an uninterrupted one would. The input is the `rgb` wire
(uint8 pixels); the other wires are not ported.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig
from tinyfaces_tpu_torch.data import overflow
from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader, PrefetchLoader
from tinyfaces_tpu_torch.data.targets import build_targets
from tinyfaces_tpu_torch.loss import AvgMeter, LossBreakdown, detection_loss
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
from tinyfaces_tpu_torch.utils.metrics_log import MetricsLogger
from tinyfaces_tpu_torch.utils.profiling import StepTimer

# Per-group learning-rate factors (reference model.py:67-87).
GROUP_LR_FACTORS = {
    "backbone": 1.0,
    "score_res3": 0.1,
    "score_res4": 1.0,
    "score4_upsample": 0.0,  # frozen bilinear upsampler
}


def make_lr_schedule(tc: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """StepLR(step_size=lr_step_epochs epochs, gamma) as a staircase over
    optimizer steps: lr(step) = lr * gamma ** (step // transition)."""
    transition = max(1, tc.lr_step_epochs * steps_per_epoch)
    return lambda step: tc.lr * tc.lr_gamma ** (step // transition)


def make_optimizer(model: TinyFacesDetector, tc: TrainConfig) -> torch.optim.SGD:
    groups = []
    for name, factor in GROUP_LR_FACTORS.items():
        if factor == 0.0:
            continue
        module = model.model if name == "backbone" else getattr(model, name)
        groups.append({"params": [p for p in module.parameters() if p.requires_grad],
                       "name": name, "lr_factor": factor, "lr": tc.lr * factor})
    return torch.optim.SGD(groups, lr=tc.lr, momentum=tc.momentum,
                           weight_decay=tc.weight_decay)


def train_step(
    model: TinyFacesDetector,
    opt: torch.optim.SGD,
    batch: dict,
    generator: torch.Generator | None,
    *,
    cfg: DetectorConfig,
    templates: torch.Tensor,
    lr: float,
    nan_guard: bool = False,
    draws: Optional[dict] = None,
) -> LossBreakdown:
    """One optimizer step in place on `model` and `opt`; returns the losses.

    `nan_guard`: when the loss or any parameter update is non-finite, the
    step's parameters, momentum and BN statistics are restored on the device
    (no host sync) and the reported total is NaN, as in the JAX package.
    `draws` replaces the step's random draws (tests feed JAX's): "noise" is
    the (B,Y,X,T,G) tie-break perturbation, "uniforms" the (pos, neg)
    balance-sampling uniforms, each (B, Y*X*T)."""
    draws = draws or {}
    model.train()
    params = [p for g in opt.param_groups for p in g["params"]]
    if nan_guard:
        old_params = [p.detach().clone() for p in params]
        old_buffers = [b.clone() for b in model.buffers()]
        old_momentum = [opt.state.get(p, {}).get("momentum_buffer") for p in params]
        old_momentum = [None if m is None else m.clone() for m in old_momentum]

    images, cls_maps, reg_maps = build_targets(batch, templates, generator, cfg,
                                               noise_tensor=draws.get("noise"))
    out = model(images)
    lb = detection_loss(
        out, cls_maps, reg_maps, generator,
        num_templates=cfg.num_templates, pos_fraction=cfg.pos_fraction,
        sample_size=cfg.sample_size, hard_neg_thresh=cfg.hard_neg_loss_thresh,
        uniforms=draws.get("uniforms"),
    )
    opt.zero_grad(set_to_none=True)
    lb.total.backward()
    for g in opt.param_groups:
        g["lr"] = lr * g["lr_factor"]
    opt.step()
    lb = LossBreakdown(*(x.detach() for x in lb))

    if nan_guard:
        with torch.no_grad():
            # A blow-up can live in the backward pass alone (inf gradient
            # under a finite loss), so gate on the update, not just the loss.
            ok = torch.isfinite(lb.total)
            for p, old in zip(params, old_params):
                ok = ok & torch.isfinite(p - old).all()
            for p, old in zip(params, old_params):
                p.copy_(torch.where(ok, p, old))
            for b, old in zip(model.buffers(), old_buffers):
                b.copy_(torch.where(ok, b, old))
            for p, old in zip(params, old_momentum):
                buf = opt.state[p]["momentum_buffer"]
                buf.copy_(torch.where(ok, buf, 0.0 if old is None else old))
            lb = lb._replace(total=torch.where(ok, lb.total, torch.nan))
    return lb


def print_state(idx: int, epoch: int, size: int, loss_cls: float, loss_reg: float):
    """Reference console format (trainer.py:9-17)."""
    if epoch >= 0:
        message = "Epoch: [{0}][{1}/{2}]\t".format(epoch, idx, size)
    else:
        message = "Val: [{0}/{1}]\t".format(idx, size)
    print(
        message
        + "\tloss_cls: {loss_cls:.6f}\tloss_reg: {loss_reg:.6f}".format(
            loss_cls=loss_cls, loss_reg=loss_reg
        )
    )


def _to_host(obj):
    """Copy of a (nested) state with every tensor moved to host memory."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


_write_lock = threading.Lock()  # one checkpoint file written at a time
_pending: list[threading.Thread] = []
_failures: list[BaseException] = []


def _write(payload: dict, path: Path) -> None:
    with _write_lock:
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)  # atomic: a reader never sees a partial file


def _write_in_background(payload: dict, path: Path) -> None:
    try:
        _write(payload, path)
    except BaseException as e:  # reported by wait_for_checkpoints
        _failures.append(e)


def save_checkpoint(model: TinyFacesDetector, opt: torch.optim.Optimizer, step: int,
                    epoch: int, batch_size: int, save_path: str | Path = "weights",
                    filename: str = "checkpoint", block: bool = True) -> Path:
    """torch.save of {model, optimizer, step, epoch, batch_size}. The state
    is copied to host memory first; `block=False` then writes it on a
    background thread, and training goes on: call `wait_for_checkpoints()`
    before exit or before reading the file back."""
    path = Path(save_path).absolute() / filename
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"model": _to_host(model.state_dict()), "optimizer": _to_host(opt.state_dict()),
               "step": int(step), "epoch": int(epoch), "batch_size": int(batch_size)}
    if block:
        _write(payload, path)
    else:
        thread = threading.Thread(target=_write_in_background, args=(payload, path),
                                  name=f"checkpoint {filename}")
        _pending.append(thread)
        thread.start()
    return path


def wait_for_checkpoints() -> None:
    """Block until every background save has been written; raises if one
    failed."""
    while _pending:
        _pending.pop(0).join()
    if _failures:
        errors = list(_failures)
        _failures.clear()
        raise RuntimeError(f"{len(errors)} background checkpoint write(s) failed") from errors[0]


def load_checkpoint(path: str | Path, map_location="cpu") -> dict:
    return torch.load(Path(path).absolute(), map_location=map_location, weights_only=True)


@dataclasses.dataclass
class Trainer:
    """Epoch loop mirroring the reference main.py/trainer.py flow."""

    model: TinyFacesDetector
    cfg: DetectorConfig
    tc: TrainConfig
    templates: np.ndarray
    device: torch.device | str = "cuda"
    seed: int = 0
    nan_guard: bool = False  # drop non-finite updates on device
    metrics_path: Optional[str | Path] = None  # JSONL structured log
    augment: str = "native"  # "native": the C++ engine; "python": dataset[i]

    def __post_init__(self):
        if self.augment not in ("native", "python"):
            raise ValueError(f"augment must be 'native' or 'python', not {self.augment!r}")
        self.device = torch.device(self.device)
        self.model.to(self.device)
        self.templates_t = torch.as_tensor(np.asarray(self.templates), dtype=torch.float32,
                                           device=self.device)
        self.opt: Optional[torch.optim.SGD] = None
        self.schedule: Optional[Callable[[int], float]] = None
        self.step = 0
        self.class_average = AvgMeter()
        self.reg_average = AvgMeter()
        self.skipped_steps = 0  # non-finite-loss steps seen
        self.loader_wait_ms: list[float] = []  # per batch, of the last epoch
        self.metrics = MetricsLogger(self.metrics_path)

    def setup(self, steps_per_epoch: int) -> None:
        self.opt = make_optimizer(self.model, self.tc)
        self.schedule = make_lr_schedule(self.tc, steps_per_epoch)

    def restore(self, payload: dict) -> None:
        """Load a `load_checkpoint` payload into the model and optimizer."""
        self.model.load_state_dict(payload["model"])
        self.opt.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])

    def close(self) -> None:
        self.metrics.close()

    def step_generator(self) -> torch.Generator:
        seed = np.random.SeedSequence((self.seed, self.step)).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def train_step(self, batch: dict) -> LossBreakdown:
        lb = train_step(self.model, self.opt, batch, self.step_generator(), cfg=self.cfg,
                        templates=self.templates_t, lr=self.schedule(self.step),
                        nan_guard=self.nan_guard)
        self.step += 1
        return lb

    def train_epoch(self, dataset, epoch: int, log_every: int = 1) -> StepTimer:
        """One pass over `dataset`; returns the epoch's StepTimer (step 0 is
        its warmup, so its rates are steady-state). With augment="native"
        `dataset` is a train WIDERFace whose samples the C++ engine
        augments; with "python" its items are taken as they come (a
        WIDERFace's Python augmentation, or any map-style dataset of
        train-sample dicts)."""
        cls = NativePrefetchLoader if self.augment == "native" else PrefetchLoader
        loader = cls(dataset, self.tc.batch_size, device=self.device, workers=self.tc.workers,
                     seed=self.seed, epoch=epoch)
        timer = StepTimer(warmup=1)
        n_batches = len(loader)
        # Loss scalars are fetched lazily: the host blocks on the device only
        # at logging points.
        pending: list = []
        # This step's per-image losses; the console's running averages
        # follow the reference's never-reset AvgMeter.
        last_step_loss = {"cls": None, "reg": None}

        def drain():
            # Fetching the loss waits for the step to finish on the device,
            # so ticking here measures finished work, not the enqueue.
            for pidx, bsz, plb in pending:
                total = float(plb.total)
                if not np.isfinite(total):
                    self.skipped_steps += 1
                    print(f"WARNING: non-finite loss at step {pidx} "
                          f"({'update dropped' if self.nan_guard else 'UPDATE APPLIED — enable nan_guard'})")
                else:
                    self.class_average.update(float(plb.class_loss), bsz)
                    self.reg_average.update(float(plb.reg_loss), bsz)
                    last_step_loss["cls"] = float(plb.class_loss) / bsz
                    last_step_loss["reg"] = float(plb.reg_loss) / bsz
                timer.tick(items=bsz)
            pending.clear()

        batches = iter(loader)
        batch = next(batches, None)
        idx = 0
        while batch is not None:
            lb = self.train_step(batch)
            pending.append((idx, batch["image"].shape[0], lb))
            # Take the next batch (queue hand-over, non-blocking upload)
            # while this step runs on the device.
            batch = next(batches, None)
            if idx % log_every == 0:
                drain()
                print_state(idx, epoch, n_batches,
                            self.class_average.average, self.reg_average.average)
                self.metrics.log(
                    epoch=epoch, step=idx,
                    loss_cls=self.class_average.average,
                    loss_reg=self.reg_average.average,
                    loss_cls_step=last_step_loss["cls"],
                    loss_reg_step=last_step_loss["reg"],
                    images_per_sec=timer.items_per_sec,
                )
            idx += 1
        drain()
        self.loader_wait_ms = list(loader.wait_ms)
        if timer.measured_steps:
            print(f"epoch {epoch}: {timer.items_per_sec:.2f} images/sec")
            ov = overflow.snapshot()
            if ov["dropped_boxes"]:
                print(f"epoch {epoch}: GT truncation — "
                      f"{ov['dropped_boxes']} boxes dropped over "
                      f"{ov['truncated_samples']} crops (cumulative); "
                      f"consider raising DetectorConfig.max_gt")
            self.metrics.log(
                epoch=epoch, event="epoch_end",
                loss_cls=self.class_average.average,
                loss_reg=self.reg_average.average,
                images_per_sec=timer.items_per_sec,
                gt_dropped_boxes=ov["dropped_boxes"],
            )
        return timer

"""Training runtime: optimizer, train step, epoch loop, checkpoints.

Port of tinyfaces_tpu/trainer.py (reference trainer.py:68-90, main.py:66-104)
for one device per process:
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
(uint8 pixels), `yuv420` (the augmented pixels as planar YCbCr 4:2:0,
converted on the device) or `jpegdct` (DCT coefficients of each sample's
source region, augmented on the device).

Under a process group of N ranks (parallel/distributed.py) `TrainConfig.
batch_size` is the global batch: each rank loads its rows of it, BatchNorm
reduces its statistics over every rank (models/resnet.py), the step's draws
are made for the global batch and each rank keeps its rows, and the
gradients are all-reduced with SUM (the loss is a sum over the batch, so
the global gradient is the sum of the local ones; DDP's mean would be off
by N). World N then computes what world 1 computes on the same global
batch. The logged losses are all-reduced and averaged over the global
rows; only rank 0 prints the console lines and writes the JSONL, and only
rank 0 writes a checkpoint.

Every step takes one route, `TrainSteps` (`Trainer.train_step` and
`make_multi_train_step` both). On one CUDA card (one process, `nan_guard`
off: `replays_step`) each step is a replay of one captured CUDA graph of
the step (utils/graphs.py), its draws made outside the graph from the
step's generator: the first step runs eagerly on a side stream, the next
captures the step and replays it, a new learning rate captures again, and
a new batch shape runs one eager step on the side stream before its
capture. Everywhere else (the CPU, a process group, `nan_guard`) the step
is the eager `train_step`. `Trainer.step_counts` counts the eager steps,
the captures and the replays.

The train step's convolutions run on the cuDNN engines that cuDNN's timed
search picks (`timed_engines`, PyTorch's benchmark mode), not on its
heuristics' guess: the search times each convolution key's candidates at
its first call, which is an eager step (a batch shape's warm-up on the
captured route), and a capture or a later step reuses the plan it cached.
`step_counts["tuned"]` counts those steps, one per batch shape since the
last `setup`/`restore`.

A ViT backbone's `epoch_end` record also holds its attention counters
(`attention_stats`: calls by kind and backend, tokens and padding tokens).

A step's spans (utils/profiling.py), when they record: `train.step`
(`TrainSteps.step`, attributes `step`, `path`: `eager`, `capture` or
`replay`, and `tuned`: 1 where the step ran the timed search) around its
phases `train.targets` (build_targets, K1's launch inside),
`train.forward`, `train.loss`, `train.backward` and `train.update` (the
gradients' all-reduce, the rates, `opt.step()`); `train.replay` a captured
step's replay, inside `train.step`. A captured step's five phase spans are
recorded once, by its capture: a replay records `train.step` and
`train.replay` alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
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
from tinyfaces_tpu_torch.ops.assignment_kernel import draw_seeds
from tinyfaces_tpu_torch.ops.sampling import draw_uniforms
from tinyfaces_tpu_torch.parallel import distributed
from tinyfaces_tpu_torch.parallel.mesh import rank_device
from tinyfaces_tpu_torch.utils import graphs
from tinyfaces_tpu_torch.utils.metrics_log import MetricsLogger
from tinyfaces_tpu_torch.utils.profiling import StepTimer, span

# Per-group learning-rate factors (reference model.py:67-87).
GROUP_LR_FACTORS = {
    "backbone": 1.0,
    "score_res3": 0.1,
    "score_res4": 1.0,
    "score4_upsample": 0.0,  # frozen bilinear upsampler
}


# How many of cuDNN's candidate engines the timed search times for each
# convolution key, in its heuristics' order (0: every engine). On an H100,
# ResNet-101 batch 12 at 500x500 in fp32: 5 keeps the device step of 10 and
# of 0 at a quarter of their search's seconds (PERF.md, the limit table).
SEARCH_LIMIT = 5


@contextlib.contextmanager
def timed_engines():
    """cuDNN's timed engine search (`torch.backends.cudnn.benchmark`, at
    `SEARCH_LIMIT`) around a train step's eager work or capture: the first
    call of each convolution key times the candidate engines and keeps the
    fastest, in a cache of the process that every later call of the key
    reuses. Only `benchmark` and `benchmark_limit` are set, and both are
    restored after: TF32, `deterministic` (a deterministic caller's search
    times deterministic engines alone) and `enabled` stay the caller's, and
    the process's flags are the same after the step as before. Off a card
    nothing reads the flags."""
    cudnn = torch.backends.cudnn
    has_limit = cudnn.is_available()  # a CPU build has no benchmark_limit
    old = (cudnn.benchmark, cudnn.benchmark_limit if has_limit else None)
    cudnn.benchmark = True
    if has_limit:
        cudnn.benchmark_limit = SEARCH_LIMIT
    try:
        yield
    finally:
        cudnn.benchmark = old[0]
        if has_limit:
            cudnn.benchmark_limit = old[1]


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


def step_generator(seed: int, step: int, device: torch.device | str) -> torch.Generator:
    """The generator of step `step`'s draws in a run seeded with `seed`."""
    s = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def step_draws(generator: torch.Generator, rows: int, n_anchors: int) -> dict:
    """The draws train_step makes from `generator`, in its order, for a
    batch of `rows` images of `n_anchors` anchors: K1's per-image seeds
    ("seeds", assign_targets_fused), then the balance-sampling uniforms
    ("uniforms", balance_sample_batch). On the generator's device."""
    dev = generator.device
    return {"seeds": draw_seeds(generator, rows, dev),
            "uniforms": draw_uniforms(generator, rows, n_anchors, dev)}


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
    the (B,Y,X,T,G) tie-break perturbation (the CPU twin's), "seeds" K1's
    (B,) int32 per-image seeds, "uniforms" the (pos, neg) balance-sampling
    uniforms, each (B, Y*X*T), all for the global batch.

    Under a process group of N ranks `batch` is this rank's rows of the
    global batch, the draws are made (or taken) for the global batch and
    this rank's rows kept, the gradients are all-reduced with SUM before
    the update, and the returned losses are the global batch's.

    The step runs under `timed_engines`."""
    opt.zero_grad(set_to_none=True)
    with timed_engines():
        return _step_body(model, opt, batch, generator, cfg=cfg, templates=templates, lr=lr,
                          nan_guard=nan_guard, draws=draws)


def _step_body(model, opt, batch, generator, *, cfg, templates, lr, nan_guard, draws):
    """train_step after zero_grad: the gradients are None on entry, so the
    backward pass writes them afresh (what a CUDA graph captures)."""
    part = (distributed.rank(), distributed.world())
    b = batch["gt_boxes"].shape[0]
    rows = slice(part[0] * b, (part[0] + 1) * b)
    draws = draws or {}
    noise, seeds, uniforms = draws.get("noise"), draws.get("seeds"), draws.get("uniforms")
    if noise is not None:
        noise = noise[rows]
    if seeds is not None:
        seeds = seeds[rows]
    if uniforms is not None:
        uniforms = tuple(u[rows] for u in uniforms)
    model.train()
    params = [p for g in opt.param_groups for p in g["params"]]
    if nan_guard:
        old_params = [p.detach().clone() for p in params]
        old_buffers = [b.clone() for b in model.buffers()]
        old_momentum = [opt.state.get(p, {}).get("momentum_buffer") for p in params]
        old_momentum = [None if m is None else m.clone() for m in old_momentum]

    with span("train.targets"):
        images, cls_maps, reg_maps = build_targets(batch, templates, generator, cfg,
                                                   noise_tensor=noise, part=part, seed=seeds)
    with span("train.forward"):
        out = model(images)
    with span("train.loss"):
        lb = detection_loss(
            out, cls_maps, reg_maps, generator,
            num_templates=cfg.num_templates, pos_fraction=cfg.pos_fraction,
            sample_size=cfg.sample_size, hard_neg_thresh=cfg.hard_neg_loss_thresh,
            uniforms=uniforms, part=part,
        )
    with span("train.backward"):
        lb.total.backward()
    lb = LossBreakdown(*(x.detach() for x in lb))
    with span("train.update"):
        if part[1] > 1:
            distributed.all_reduce_tensors([p.grad for p in params if p.grad is not None])
            losses = torch.stack(list(lb))
            distributed.all_reduce_tensors([losses], kind="loss")
            lb = LossBreakdown(*losses.unbind())
        for g in opt.param_groups:
            g["lr"] = lr * g["lr_factor"]
        opt.step()

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


def replays_step(device: torch.device, nan_guard: bool) -> bool:
    """Whether `TrainSteps` replays a captured graph of the step: on a CUDA
    card, in one process (a process group's all-reduces are not captured)
    and with `nan_guard` off (the captured step has no guard)."""
    return device.type == "cuda" and distributed.world() == 1 and not nan_guard


def _shapes_of(batch: dict) -> tuple:
    """The batch's names, shapes and dtypes: what its convolutions' cuDNN
    keys depend on."""
    return tuple((k, v.shape, v.dtype) for k, v in sorted(batch.items()))


class TrainSteps:
    """The train step's one route, which `Trainer.train_step` and
    `make_multi_train_step` take. A step draws from `step_generator(seed,
    step)` unless the caller hands it `draws`; a replayed step's draws are
    `step_draws` of that generator, made outside the graph.

    Where `replays_step` holds, a step at batch shapes not warmed up since
    `drop()` runs eagerly on a side stream (the warm-up, in which cuDNN's
    timed search picks each convolution's engine: `timed_engines`); the
    next captures the step into one `graphs.Captured` and replays it; each
    later step replays it, or captures again first where its key (lr,
    shapes) is new (shapes warmed up before, or the staircase's next rate).
    The old graph is dropped before a new capture or warm-up, so two memory
    pools never coexist. Elsewhere each step is the eager `train_step`.
    `drop()` forgets the graph and the warmed shapes: the next step is
    eager again (a new optimizer has no momentum yet, and a capture would
    bake in its first step's).

    `step_counts` counts the eager steps, the captures and the replayed
    steps, and "tuned": the eager steps at shapes new since `drop()`, in
    which cuDNN's timed search ran; `tuned_s` is their seconds, the
    device's work included."""

    def __init__(self):
        self.graph: Optional[graphs.Captured] = None
        self.key: Optional[tuple] = None  # (lr, shapes) of the graph
        self.warm: set = set()  # _shapes_of the batches warmed up since drop()
        self.step_counts = {"eager": 0, "captured": 0, "replayed": 0, "tuned": 0}
        self.tuned_s = 0.0

    def drop(self) -> None:
        self.graph, self.key, self.warm = None, None, set()

    def path(self, batch: dict, lr: float, graphed: bool = True) -> str:
        """What the next step does: "eager", "capture" (then replay) or
        "replay"; `graphed`: whether `replays_step` holds."""
        shapes = _shapes_of(batch)
        if not graphed or shapes not in self.warm:
            return "eager"
        return "replay" if self.key == (lr, shapes) else "capture"

    def step(self, model, opt, batch: dict, *, cfg, templates, lr: float, seed: int, step: int,
             nan_guard: bool = False, draws: Optional[dict] = None) -> LossBreakdown:
        """Step `step` at rate `lr`, in the span `train.step` (attributes
        `step`, `path` and `tuned`); a tuned step is timed to its end on
        the device. Replayed losses are copied out of the graph's buffers,
        so no later replay overwrites them."""
        dev = batch["gt_boxes"].device
        graphed = replays_step(dev, nan_guard)
        path = self.path(batch, lr, graphed)
        tuned = _shapes_of(batch) not in self.warm
        t0 = time.perf_counter()
        with span("train.step", step=step, path=path, tuned=int(tuned)):
            gen = step_generator(seed, step, dev)
            if graphed:  # a graph takes the step's draws as inputs: made here, outside it
                if draws is None:
                    n_anchors = cfg.heatmap_size[0] * cfg.heatmap_size[1] * cfg.num_templates
                    draws = step_draws(gen, batch["gt_boxes"].shape[0], n_anchors)
                gen = None

            def run(batch, draws):
                return train_step(model, opt, batch, gen, cfg=cfg, templates=templates, lr=lr,
                                  nan_guard=nan_guard, draws=draws)

            if path == "eager":
                self.graph = self.key = None  # free its pool: the next step captures
                with graphs.side_stream(dev) if graphed else contextlib.nullcontext():
                    lb = run(batch, draws)
                self.warm.add(_shapes_of(batch))
            else:
                if path == "capture":
                    self.graph = None  # free its pool before the next capture
                    self.graph = graphs.Captured(run, batch, draws, device=dev)
                    self.key = (lr, _shapes_of(batch))
                with span("train.replay"):  # a replay's phase spans were recorded by its capture
                    lb = LossBreakdown(*torch.stack(list(self.graph.replay(batch, draws))).unbind())
            if tuned and dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if tuned:
            self.tuned_s += time.perf_counter() - t0
        self.step_counts["eager" if path == "eager" else "replayed"] += 1
        self.step_counts["captured"] += path == "capture"
        self.step_counts["tuned"] += tuned
        return lb


def make_multi_train_step(model: TinyFacesDetector, opt: torch.optim.SGD, cfg: DetectorConfig,
                          templates: torch.Tensor, schedule: Callable[[int], float]) -> Callable:
    """K optimizer steps per call, the counterpart of the JAX package's
    make_multi_train_step (lax.scan over stacked batches in one dispatch).

    Returns `multi(batches, seed, step, draws=None) -> LossBreakdown` with
    (K,) leaves: `batches` holds the K steps' batches stacked on a leading
    axis, step `step + k` runs at learning rate `schedule(step + k)` with
    the draws train_step makes from `step_generator(seed, step + k)` (as
    Trainer's steps draw them), or with `draws[k]` (tests feed JAX's). The
    K steps equal K calls of train_step.

    The steps run through one `TrainSteps`, as Trainer.train_step's do: on
    a card the first step at each batch shape eagerly on a side stream
    (cuDNN's timed search runs there), the next captured into one CUDA
    graph, and each step a replay. The learning rate stays a Python float
    in the optimizer, baked into the graph: torch's SGD applies it as
    `add_(grad, alpha=-lr)`, and a tensor rate would take another rounding
    path, so one graph is captured per rate of the staircase schedule (and
    per batch shape). A capture that fails raises; nothing falls back to
    eager steps on a card. One process only: a process group is refused."""
    steps = TrainSteps()

    def multi(batches: dict, seed: int, step: int, draws: Optional[list] = None) -> LossBreakdown:
        if distributed.world() > 1:
            raise ValueError("make_multi_train_step runs one process (the JAX tool runs it on "
                             f"one device); this process group has {distributed.world()} ranks")
        out = []
        for k in range(batches["gt_boxes"].shape[0]):
            lb = steps.step(model, opt, {name: v[k] for name, v in batches.items()}, cfg=cfg,
                            templates=templates, lr=schedule(step + k), seed=seed, step=step + k,
                            draws=None if draws is None else draws[k])
            out.append(torch.stack(list(lb)))
        return LossBreakdown(*torch.stack(out).unbind(1))

    return multi


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
    before exit or before reading the file back.

    Under a process group every rank calls it and rank 0 writes (the ranks
    hold the same state); a blocking save ends in a barrier, so no rank
    reads the file before it is whole. A background save is waited for by
    rank 0's `wait_for_checkpoints()`, before the exit barrier."""
    path = Path(save_path).absolute() / filename
    if distributed.rank() != 0:
        if block:
            distributed.barrier()
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"model": _to_host(model.state_dict()), "optimizer": _to_host(opt.state_dict()),
               "step": int(step), "epoch": int(epoch), "batch_size": int(batch_size)}
    if block:
        _write(payload, path)
        if distributed.world() > 1:
            distributed.barrier()
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
    """Epoch loop mirroring the reference main.py/trainer.py flow. Under a
    process group, each rank's model lives on `mesh.rank_device(device,
    rank)`; rank 0's parameters and buffers are broadcast after `setup`
    and `restore`."""

    model: TinyFacesDetector
    cfg: DetectorConfig
    tc: TrainConfig
    templates: np.ndarray
    device: torch.device | str = "cuda"
    seed: int = 0
    nan_guard: bool = False  # drop non-finite updates on device
    metrics_path: Optional[str | Path] = None  # JSONL structured log
    augment: str = "native"  # "native": the C++ engine; "python": dataset[i]
    transfer: str = "rgb"  # train-input wire: "rgb" or "yuv420" pixels, "jpegdct" coefficients

    def __post_init__(self):
        if self.augment not in ("native", "python"):
            raise ValueError(f"augment must be 'native' or 'python', not {self.augment!r}")
        self.rank, self.world = distributed.rank(), distributed.world()
        self.device = rank_device(self.device, self.rank)
        self.model.to(self.device)
        self.templates_t = torch.as_tensor(np.asarray(self.templates), dtype=torch.float32,
                                           device=self.device)
        self.opt: Optional[torch.optim.SGD] = None
        self.schedule: Optional[Callable[[int], float]] = None
        self.step = 0
        self.class_average = AvgMeter()
        self.reg_average = AvgMeter()
        self.skipped_steps = 0  # non-finite-loss steps seen
        self._steps = TrainSteps()
        # one console and one JSONL per run: rank 0's
        self.metrics = MetricsLogger(self.metrics_path if self.rank == 0 else None)

    def _broadcast_state(self) -> None:
        if self.world > 1:
            distributed.broadcast_tensors([*self.model.parameters(), *self.model.buffers()])

    def setup(self, steps_per_epoch: int) -> None:
        self._steps.drop()  # its graph baked in the old optimizer's momentum
        self.opt = make_optimizer(self.model, self.tc)
        self.schedule = make_lr_schedule(self.tc, steps_per_epoch)
        self._broadcast_state()

    def restore(self, payload: dict) -> None:
        """Load a `load_checkpoint` payload into the model and optimizer."""
        self._steps.drop()  # load_state_dict replaces the momentum a graph baked in
        self.model.load_state_dict(payload["model"])
        self.opt.load_state_dict(payload["optimizer"])
        self.step = int(payload["step"])
        self._broadcast_state()

    def close(self) -> None:
        self.metrics.close()

    def step_generator(self) -> torch.Generator:
        return step_generator(self.seed, self.step, self.device)

    @property
    def step_counts(self) -> dict:
        """TrainSteps.step_counts of this Trainer's steps."""
        return self._steps.step_counts

    @property
    def tuned_s(self) -> float:
        return self._steps.tuned_s

    def train_step(self, batch: dict) -> LossBreakdown:
        """One step of the Trainer's `TrainSteps`, at the schedule's rate,
        with the draws of `step_generator()`."""
        lb = self._steps.step(self.model, self.opt, batch, cfg=self.cfg, templates=self.templates_t,
                              lr=self.schedule(self.step), seed=self.seed, step=self.step,
                              nan_guard=self.nan_guard)
        self.step += 1
        return lb

    def train_epoch(self, dataset, epoch: int, log_every: int = 1) -> StepTimer:
        """One pass over `dataset`; returns the epoch's StepTimer (step 0 is
        its warmup, so its rates are steady-state). With augment="native"
        `dataset` is a train WIDERFace whose samples the C++ engine
        augments; with "python" its items are taken as they come (a
        WIDERFace's Python augmentation, or any map-style dataset of
        train-sample dicts). With transfer="jpegdct" either loader takes
        the dataset's `getitem_train_dct`; with "yuv420" either converts
        its samples' pixels (loader pack="yuv420")."""
        cls = NativePrefetchLoader if self.augment == "native" else PrefetchLoader
        loader = cls(dataset, self.tc.batch_size, device=self.device, workers=self.tc.workers,
                     seed=self.seed, epoch=epoch, pack=self.transfer, rank=self.rank,
                     world=self.world)
        timer = StepTimer(warmup=1)
        n_batches = len(loader)
        replayed, tuned, tuned_s = self.step_counts["replayed"], self.step_counts["tuned"], self.tuned_s
        attn_calls = graphs.launch_counts("sdpa.")
        # Loss scalars are fetched lazily: the host blocks on the device only
        # at logging points.
        pending: list = []
        # This step's per-image losses; the console's running averages
        # follow the reference's never-reset AvgMeter. The losses are the
        # global batch's, so they are averaged over its rows on every rank.
        last_step_loss = {"cls": None, "reg": None}
        primary = self.rank == 0

        def drain():
            # Fetching the loss waits for the step to finish on the device,
            # so ticking here measures finished work, not the enqueue.
            for pidx, bsz, plb in pending:
                total = float(plb.total)
                if not np.isfinite(total):
                    self.skipped_steps += 1
                    if primary:
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
            images = next(batch[k] for k in ("image", "image_y", "dct_wire") if k in batch)
            pending.append((idx, images.shape[0] * self.world, lb))
            # Take the next batch (queue hand-over, non-blocking upload)
            # while this step runs on the device.
            batch = next(batches, None)
            if idx % log_every == 0:
                drain()
                if primary:
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
        if timer.measured_steps:
            ov = overflow.snapshot()
            if primary:
                print(f"epoch {epoch}: {timer.items_per_sec:.2f} images/sec")
            if primary and ov["dropped_boxes"]:
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
                replayed_steps=self.step_counts["replayed"] - replayed,
                tuned_steps=self.step_counts["tuned"] - tuned,
                tuned_s=self.tuned_s - tuned_s,
                **self.attention_stats(attn_calls),
            )
        return timer

    def attention_stats(self, since: Optional[dict] = None) -> dict:
        """A ViT backbone's attention counters (models/vitdet.py): its
        attention calls by kind and backend since the `graphs.launch_counts
        ("sdpa.")` reading `since` (replays included), and its last forward's
        `attn_tokens` and `attn_pad_tokens`; nothing for a ResNet."""
        tokens = getattr(self.model.model, "tokens", None)
        if tokens is None:
            return {}
        since = since or {}
        calls = {k: n - since.get(k, 0) for k, n in graphs.launch_counts("sdpa.").items()}
        return {"attn_calls": calls, **tokens}

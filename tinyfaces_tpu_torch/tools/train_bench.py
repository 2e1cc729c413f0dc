"""Training-step throughput on synthetic WIDER-like data.

    python -m tinyfaces_tpu_torch.tools.train_bench [--batch 12] [--iters 20] [--bf16]
        [--remat] [--fast-precision] [--device cuda]

Port of tools/train_bench.py: `Trainer.train_step` (normalization, K1, the
ResNet-101 forward and backward, SGD) end to end, with each step's host
batch made (bench_train.make_synthetic_train_batch) and uploaded inside
the timed loop, at the reference batch size. Prints ms/step and img/s. On
a card the Trainer's step is a replay of its captured CUDA graph of the
step (`trainer.replays_step`), so this plain line times the replayed step;
its warm-up step and its capture run before the clock starts.

`--remat` recomputes each bottleneck in the backward pass (the model's
`remat`). `--fast-precision` lets the fp32 convolutions and matmuls run in
TF32, the card's counterpart of the TPU's single-pass bf16 MXU; without
it, fp32 means fp32. `--multi K` runs K steps per call of
`trainer.make_multi_train_step` (on a card, replays of one captured CUDA
graph of the step; the JAX tool's lax.scan over K stacked batches), each
call on K fresh host batches stacked and uploaded inside the timed loop,
prints the JAX tool's `train_step[... scan xK]` line, then times the plain
step the same way on the same card and prints its line too.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Sequence

import numpy as np
import torch

from tinyfaces_tpu_torch.models.resnet import RESNET101_STAGES

from tinyfaces_tpu_torch.bench_train import make_synthetic_train_batch, pinned


def run(trainer, make_batch: Callable[[], dict], iters: int) -> dict:
    """One warm-up step (two where the Trainer replays a captured step: the
    second captures), then `iters` timed steps, each on a fresh host batch
    from make_batch() uploaded inside the loop; the device is synchronised
    before the clock stops. Returns the rates, every step's loss (warm-up
    first) and K1's launches in all of them."""
    from tinyfaces_tpu_torch.trainer import replays_step
    from tinyfaces_tpu_torch.utils import graphs
    from tinyfaces_tpu_torch.utils.instruments import peak_gib, reset_peak, sync

    dev = torch.device(trainer.device)

    def step():
        host = pinned(make_batch(), dev)
        return trainer.train_step({k: v.to(dev, non_blocking=True) for k, v in host.items()})

    launches0 = graphs.launches("k1")
    t0 = time.perf_counter()
    losses = [step().total]
    if replays_step(dev, trainer.nan_guard):
        losses.append(step().total)
    first_s = time.perf_counter() - t0
    reset_peak(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(step().total)
    sync(dev)
    dt = (time.perf_counter() - t0) / iters
    batch = trainer.tc.batch_size
    return {"first_step_s": first_s, "ms_per_step": 1e3 * dt, "img_per_s": batch / dt,
            "losses": [float(x) for x in losses], "iters": iters,
            "warmup_steps": len(losses) - iters, "batch": batch,
            "k1_launches": graphs.launches("k1") - launches0, "peak_gib": peak_gib(dev)}


def run_multi(trainer, make_batch: Callable[[], dict], k: int, iters: int) -> dict:
    """One warm-up call (on a card the warm-up step and the graph capture),
    then `iters` timed calls of K steps each, every call on K fresh host
    batches stacked on a leading axis and uploaded inside the loop; the
    device is synchronised before the clock stops. Returns the rates per
    step, every step's loss, K1's launches in all of them and the peak
    memory of the whole run (the capture's pool included)."""
    from tinyfaces_tpu_torch.trainer import make_multi_train_step
    from tinyfaces_tpu_torch.utils import graphs
    from tinyfaces_tpu_torch.utils.instruments import peak_gib, reset_peak, sync

    dev = torch.device(trainer.device)
    multi = make_multi_train_step(trainer.model, trainer.opt, trainer.cfg, trainer.templates_t,
                                  trainer.schedule)

    def call():
        batches = [make_batch() for _ in range(k)]
        host = pinned({n: np.stack([b[n] for b in batches]) for n in batches[0]}, dev)
        lbs = multi({n: v.to(dev, non_blocking=True) for n, v in host.items()}, trainer.seed,
                    trainer.step)
        trainer.step += k
        return lbs.total

    launches0 = graphs.launches("k1")
    # the graph's memory pool is allocated by the capture in the first call
    reset_peak(dev)
    t0 = time.perf_counter()
    losses = [call()]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        losses.append(call())
    sync(dev)
    dt = (time.perf_counter() - t0) / (iters * k)
    batch = trainer.tc.batch_size
    return {"first_call_s": first_s, "ms_per_step": 1e3 * dt, "img_per_s": batch / dt,
            "losses": [float(x) for x in torch.cat(losses)], "iters": iters, "k": k,
            "batch": batch, "k1_launches": graphs.launches("k1") - launches0,
            "peak_gib": peak_gib(dev)}


def main(argv=None, *, stage_sizes: Sequence[int] = RESNET101_STAGES) -> dict:
    """The CLI; `stage_sizes` is the published ResNet-101, only tests
    shrink it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--multi", type=int, default=0,
                    help="K>0: K steps per call of make_multi_train_step (one captured CUDA "
                         "graph on a card), then the plain step for comparison")
    ap.add_argument("--fast-precision", action="store_true",
                    help="TF32 for the fp32 convolutions and matmuls")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)
    from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig
    from tinyfaces_tpu_torch.data import load_templates
    from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
    from tinyfaces_tpu_torch.tools.profile_model import achieved, train_step_flops
    from tinyfaces_tpu_torch.trainer import Trainer
    from tinyfaces_tpu_torch.utils.instruments import card, device_name, resolve_device

    dev = resolve_device(args.device)
    tf32 = args.bf16 or args.fast_precision
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cfg = DetectorConfig()
    model = TinyFacesDetector(stage_sizes=stage_sizes, remat=args.remat,
                              dtype=torch.bfloat16 if args.bf16 else None)
    init_model(model, torch.Generator().manual_seed(0))
    trainer = Trainer(model=model, cfg=cfg, tc=TrainConfig(batch_size=args.batch),
                      templates=load_templates(), device=dev)
    trainer.setup(steps_per_epoch=1000)
    rng = np.random.default_rng(0)
    kind = "bf16" if args.bf16 else ("tf32" if args.fast_precision else "fp32")
    multi = None
    if args.multi > 0:
        multi = run_multi(trainer, lambda: make_synthetic_train_batch(rng, args.batch, cfg),
                          args.multi, args.iters)
        print(f"first call (warm-up step, capture, {args.multi - 1} replays) "
              f"{multi['first_call_s']:.1f} s")
        print(f"train_step[{kind} scan x{args.multi}] batch={args.batch}: "
              f"{multi['ms_per_step']:.1f} ms/step, {multi['img_per_s']:.2f} images/sec/chip; "
              f"kernel launches: dense_assignment_reductions {multi['k1_launches']} in "
              f"{(args.iters + 1) * args.multi} steps ({card(dev)})")
    out = run(trainer, lambda: make_synthetic_train_batch(rng, args.batch, cfg), args.iters)
    flops = train_step_flops(args.batch, cfg.input_size, stage_sizes) / args.batch
    out.update(card=card(dev), dtype=kind, remat=args.remat, flops_per_image=flops,
               **achieved(flops, out["img_per_s"], device_name(dev), kind))
    if multi is not None:
        out["multi"] = multi
    print(f"warm-up ({out['warmup_steps']} steps) {out['first_step_s']:.1f} s, loss {out['losses'][0]:.1f}")
    print(f"train_step[{kind}{'+remat' if args.remat else ''}] batch={args.batch}: "
          f"{out['ms_per_step']:.1f} ms/step, {out['img_per_s']:.2f} images/sec/chip, "
          f"{out['tflops']:.2f} TFLOP/s"
          + (f" ({100 * out['share_of_peak']:.1f}% of the {kind} peak)" if out["share_of_peak"] else "")
          + f"; kernel launches: dense_assignment_reductions {out['k1_launches']} in "
          f"{args.iters + out['warmup_steps']} steps; peak memory "
          + (f"{out['peak_gib']:.2f} GiB" if out["peak_gib"] is not None else "not measured (cpu)")
          + f" ({out['card']})")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

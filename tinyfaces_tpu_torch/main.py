"""Training CLI of the port — the surface of the JAX package's main.py (and
of the reference main.py:18-36), flag for flag with the same defaults, plus
`--device` (default cuda):

    python -m tinyfaces_tpu_torch.main TRAIN_ANN VAL_ANN --dataset-root DIR
        [--resume weights/checkpoint_N] [--device cuda]

Flow (reference main.py:39-104): the WIDER train data -> the detector
seeded from `--seed` (optionally its backbone from `--pretrained-backbone`)
-> SGD with per-group LRs and StepLR -> the epoch loop, in which every
sample is augmented by the C++ engine (on the rgb wire) or on the device
(jpegdct) and every step's GT assignment runs
the CUDA kernel -> `weights/checkpoint_{epoch+1}` every `--save-every`
epochs and on SIGTERM. `--resume PATH` restores model, optimizer, step and
epoch and goes on from the saved epoch unless `--start-epoch` is given.
Without `--bf16` the run is fp32 throughout: TF32 is turned off for matmuls
and convolutions (cuDNN allows it by default).

`--transfer jpegdct` reads each image's JPEG bytes instead of decoding it
with PIL: the host entropy-decodes once per image (cached) and ships the
coefficients of each crop's source region, and the device decodes and
augments them (data/dct_train.py); no PIL is needed for baseline 4:2:0 or
grayscale files.

Not ported, each exiting with the ROADMAP item that brings it: `--transfer
yuv420` (item 15) and multi-process training (`--num-processes > 1`,
`--coordinator-address`: item 13). Nothing falls
back to the CPU: without a GPU, `--device cpu` must be given.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import torch

from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig
from tinyfaces_tpu_torch.data import get_dataloader
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model
from tinyfaces_tpu_torch.models.resnet import ARCH_STAGES
from tinyfaces_tpu_torch.ops import assignment_kernel
from tinyfaces_tpu_torch.parallel.distributed import GracefulStop
from tinyfaces_tpu_torch.trainer import (Trainer, load_checkpoint, save_checkpoint,
                                         wait_for_checkpoints)
from tinyfaces_tpu_torch.utils.profiling import trace

NUM_TEMPLATES = 25  # aka the number of clusters


def arguments(argv=None):
    parser = argparse.ArgumentParser()

    parser.add_argument("traindata")
    parser.add_argument("valdata")
    parser.add_argument("--dataset-root", default="")
    parser.add_argument("--dataset", default="WIDERFace")
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--weight-decay", default=0.0005, type=float)
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--batch_size", default=12, type=int)
    parser.add_argument("--workers", default=8, type=int)
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("--epochs", default=50, type=int)
    parser.add_argument("--save-every", default=10, type=int)
    parser.add_argument("--resume", default="",
                        help="checkpoint path to resume from")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--pretrained-backbone", default="",
                        help="npz/pth with converted ImageNet ResNet-101 weights")
    parser.add_argument("--arch", default="resnet101",
                        choices=("resnet101", "resnet50"),
                        help="backbone (reference model.py:13 base_model knob)")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 activations (fp32 params)")
    parser.add_argument("--profile-dir", default="",
                        help="write a torch.profiler Chrome trace of the first epoch here")
    parser.add_argument("--max-gt", default=0, type=int,
                        help="static per-crop GT bound (0 = config default 192); "
                             "truncation past it is counted and warned "
                             "(data/overflow.py)")
    parser.add_argument("--log-every", default=1, type=int,
                        help="console cadence; >1 fetches losses less often")
    parser.add_argument("--metrics-log", default="",
                        help="append structured JSONL training metrics here")
    parser.add_argument("--transfer", default="rgb",
                        choices=("rgb", "yuv420", "jpegdct"),
                        help="train-input wire format: rgb decodes with PIL and augments "
                             "on the host; jpegdct ships DCT coefficients and augments on the "
                             "device; yuv420 is not ported (ROADMAP item 15)")
    parser.add_argument("--nan-guard", action="store_true",
                        help="drop non-finite updates on device instead of "
                             "poisoning the weights")
    parser.add_argument("--async-checkpoint", action="store_true",
                        help="write checkpoints in the background (training "
                             "continues during the save)")
    # Multi-process training: ROADMAP item 13.
    parser.add_argument("--coordinator-address", default="",
                        help="host:port of process 0 (not ported: ROADMAP item 13)")
    parser.add_argument("--num-processes", default=0, type=int,
                        help="total train processes (0 = single process; >1 not ported)")
    parser.add_argument("--process-id", default=0, type=int)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (cuda, cuda:N or cpu)")

    return parser.parse_args(argv)


def _check_supported(args) -> torch.device:
    if args.num_processes > 1 or args.coordinator_address:
        raise SystemExit("multi-process training is not ported: ROADMAP item 13")
    if args.transfer not in ("rgb", "jpegdct"):
        raise SystemExit(f"--transfer {args.transfer} is not ported: ROADMAP item 15")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda but torch.cuda.is_available() is False; "
                         "pass --device cpu to train on the CPU")
    return device


def load_backbone(model: TinyFacesDetector, path: str | Path) -> None:
    """Load only the backbone weights and BN statistics ("model." keys) of a
    JAX .npz export, a reference .pth or a port checkpoint."""
    from tinyfaces_tpu_torch.evaluation import load_weights

    backbone = {k: v for k, v in load_weights(path).items() if k.startswith("model.")}
    if not backbone:
        raise ValueError(f"{path} holds no backbone weights")
    model.load_state_dict({**model.state_dict(), **backbone})


def run(args, dataset=None) -> Trainer | None:
    """The training flow of `main()` for parsed `args`. `dataset` replaces
    the WIDER train dataset read from `args.traindata` (a train WIDERFace
    built with the same DetectorConfig, e.g. one that decodes from memory).
    Returns the Trainer after the last epoch (None for `--debug`)."""
    device = _check_supported(args)
    if not args.bf16:  # fp32 means fp32: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = DetectorConfig(num_templates=NUM_TEMPLATES)
    if args.max_gt:
        cfg = dataclasses.replace(cfg, max_gt=args.max_gt)
    tc = TrainConfig(lr=args.lr, momentum=args.momentum, weight_decay=args.weight_decay,
                     batch_size=args.batch_size, epochs=args.epochs,
                     start_epoch=args.start_epoch, save_every=args.save_every,
                     workers=args.workers)

    if dataset is None:
        dataset, templates = get_dataloader(args.traindata, args, NUM_TEMPLATES, cfg=cfg,
                                            train=True, split="train")
    else:
        if dataset.cfg != cfg:
            raise ValueError(f"the dataset's DetectorConfig {dataset.cfg} is not the CLI's {cfg}")
        templates = dataset.templates

    if args.debug:
        debug_visualize(dataset, device)
        return None

    model = TinyFacesDetector(num_templates=NUM_TEMPLATES, stage_sizes=ARCH_STAGES[args.arch],
                              dtype=torch.bfloat16 if args.bf16 else None)
    init_model(model, torch.Generator().manual_seed(args.seed))
    if args.pretrained_backbone:
        load_backbone(model, args.pretrained_backbone)

    weights_dir = Path("weights")
    weights_dir.mkdir(exist_ok=True)
    trainer = Trainer(model=model, cfg=cfg, tc=tc, templates=templates, device=device,
                      seed=args.seed, nan_guard=args.nan_guard,
                      metrics_path=args.metrics_log or None, augment="native",
                      transfer=args.transfer)
    trainer.setup(max(1, len(dataset) // tc.batch_size))

    start_epoch = args.start_epoch
    if args.resume:
        payload = load_checkpoint(args.resume, map_location=device)
        trainer.restore(payload)
        if not start_epoch:
            start_epoch = int(payload["epoch"])

    # On SIGTERM, finish the epoch, checkpoint and stop instead of losing it.
    try:
        with GracefulStop() as stop:
            for epoch in range(start_epoch, args.epochs):
                with trace(args.profile_dir if epoch == start_epoch else None):
                    trainer.train_epoch(dataset, epoch, log_every=args.log_every)
                stop_now = stop.agreed()
                if (epoch + 1) % args.save_every == 0 or stop_now:
                    save_checkpoint(trainer.model, trainer.opt, trainer.step, epoch + 1,
                                    tc.batch_size, save_path=weights_dir,
                                    filename=f"checkpoint_{epoch + 1}",
                                    block=not args.async_checkpoint)
                if stop_now:
                    break
    finally:
        wait_for_checkpoints()
        trainer.close()
    return trainer


def debug_visualize(dataset, device: torch.device) -> None:
    """`make debug` flow (reference wider_face.py:171-183): the positive
    anchors of the first augmented sample, and its boxes drawn."""
    from PIL import Image

    from tinyfaces_tpu_torch.data.targets import build_targets
    from tinyfaces_tpu_torch.utils.visualize import visualize_bboxes

    item = dataset[0]
    batch = {k: torch.from_numpy(np.asarray(v)[None]).to(device) for k, v in item.items()}
    templates = torch.as_tensor(dataset.templates, dtype=torch.float32, device=device)
    _, cls_maps, _ = build_targets(batch, templates, torch.Generator(device=device).manual_seed(0),
                                   dataset.cfg)
    print("positive anchors:", int((cls_maps == 1).sum()))
    visualize_bboxes(Image.fromarray(item["image"]), item["gt_boxes"][item["gt_valid"]])


def main(argv=None) -> None:
    run(arguments(argv))
    # For a parent that drives this CLI as a child process (tools/train_soak.py):
    # the GT-assignment kernel's launches in this process.
    print(f"kernel launches: dense_assignment_reductions {assignment_kernel.launch_count}",
          flush=True)


if __name__ == "__main__":
    main()

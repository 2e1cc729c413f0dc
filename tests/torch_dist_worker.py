"""One rank of a multi-process run of the port on the CPU (gloo), launched
by tests/test_torch_distributed.py. Imports torch, numpy and the port only.

    python tests/torch_dist_worker.py MODE STORE WORLD RANK WORKDIR [ARGS...]

STORE is the process group's init address (a `file://` path). Modes:

  step    from WORKDIR/inputs.pt (weights, the global batch, the JAX step's
          draws): (a) one train_step with the injected draws, (b) one
          Trainer.train_step with the trainer's own draws, (c) (b) again
          with BatchNorm kept on this rank's statistics (the variant the
          global statistics replace); saves the three state_dicts and
          losses to WORKDIR/out_RANK.pt, with (d) one BatchNorm2d's output,
          input gradient and running statistics on this rank's rows of
          inputs.pt's `bn_x` under the loss sum(y * bn_g).
  resume  ARGS = full|part1|part2: 4 Trainer steps straight; 2 steps and a
          checkpoint (every rank calls save_checkpoint); restore the
          checkpoint and run steps 2..3. Prints DIGEST of the parameters,
          momentum, buffers and step.
  train   ARGS = the training CLI's argv (main.run with gloo); with
          --sigterm-rank R rank R sends itself SIGTERM on its first
          sample. Prints STOPPED with the trainer's step.
  eval    ARGS = the evaluation CLI's argv (evaluate_model.main).

The CLIs' ResNet-50 stages are cut to (1, 1, 1).
"""

import dataclasses
import hashlib
import os
import signal
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig  # noqa: E402
from tinyfaces_tpu_torch.data import load_templates  # noqa: E402
from tinyfaces_tpu_torch.models import detection, resnet  # noqa: E402
from tinyfaces_tpu_torch.models.detection import TinyFacesDetector, init_model  # noqa: E402
from tinyfaces_tpu_torch.parallel import distributed  # noqa: E402
from tinyfaces_tpu_torch.trainer import (Trainer, load_checkpoint, make_lr_schedule,  # noqa: E402
                                         make_optimizer, save_checkpoint, train_step)

CFG = DetectorConfig(input_size=(64, 64), heatmap_size=(8, 8), max_gt=4)
STAGES = (1, 1, 1)
RESUME_BATCH, RESUME_STEPS, CKPT_STEP = 8, 4, 2


def resume_batch(step: int) -> dict:
    """The global batch of a step, a pure function of the step index (as
    tests/train_resume_worker.py makes it)."""
    rng = np.random.default_rng(100 + step)
    b = RESUME_BATCH
    return {
        "image": torch.from_numpy(rng.integers(0, 255, (b, *CFG.input_size, 3), dtype=np.uint8)),
        "gt_boxes": torch.tensor([[10.0, 10.0, 40.0, 44.0]]).repeat(b, CFG.max_gt, 1),
        "gt_valid": (torch.arange(CFG.max_gt) < 1).repeat(b, 1),
        "paste_box": torch.tensor([0.0, 0.0, *CFG.input_size]).repeat(b, 1),
        "flip": torch.zeros(b, dtype=torch.bool),
    }


def local_rows(batch: dict) -> dict:
    rows = distributed.process_batch_slice(len(batch["flip"]))
    return {k: v[rows] for k, v in batch.items()}


def digest(trainer: Trainer) -> str:
    h = hashlib.sha256()
    for t in [*trainer.model.state_dict().values(),
              *(trainer.opt.state[p]["momentum_buffer"]
                for g in trainer.opt.param_groups for p in g["params"])]:
        h.update(t.detach().contiguous().numpy().tobytes())
    h.update(str(trainer.step).encode())
    return h.hexdigest()


def tiny_trainer(tc: TrainConfig, weights: dict | None = None) -> Trainer:
    model = TinyFacesDetector(stage_sizes=STAGES)
    if weights is None:
        init_model(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(weights)
    return Trainer(model, CFG, tc, load_templates(), device="cpu", seed=3, augment="python")


def mode_step(workdir: Path) -> None:
    inputs = torch.load(workdir / "inputs.pt", weights_only=True)
    batch = local_rows(inputs["batch"])
    tc = TrainConfig(batch_size=len(inputs["batch"]["flip"]))
    templates = torch.tensor(load_templates(), dtype=torch.float32)
    out = {}

    model = TinyFacesDetector(stage_sizes=STAGES)
    model.load_state_dict(inputs["weights"])
    lb = train_step(model, make_optimizer(model, tc), batch, None, cfg=CFG, templates=templates,
                    lr=make_lr_schedule(tc, 10)(0), draws=inputs["draws"])
    out["injected"] = (model.state_dict(), [x.item() for x in lb])

    def own_draws() -> tuple:
        trainer = tiny_trainer(tc, inputs["weights"])
        trainer.setup(steps_per_epoch=10)
        lb = trainer.train_step(batch)
        return trainer.model.state_dict(), [x.item() for x in lb]

    out["own"] = own_draws()
    # The variant that keeps each rank's own BatchNorm statistics.
    resnet.distributed = type("OneRank", (), {"world": staticmethod(lambda: 1)})
    out["local_bn"] = own_draws()
    resnet.distributed = distributed

    # One BatchNorm2d on channels whose mean is 1e4 times their spread.
    rows = distributed.process_batch_slice(len(inputs["bn_x"]))
    x = inputs["bn_x"][rows].clone().requires_grad_(True)
    bn = resnet.BatchNorm2d(x.shape[1]).train()
    y = bn(x)
    (y * inputs["bn_g"][rows]).sum().backward()
    out["bn"] = {"y": y.detach(), "grad": x.grad, "running_mean": bn.running_mean,
                 "running_var": bn.running_var}
    torch.save(out, workdir / f"out_{distributed.rank()}.pt")


def mode_resume(workdir: Path, phase: str) -> None:
    tc = TrainConfig(batch_size=RESUME_BATCH)
    trainer = tiny_trainer(tc)
    trainer.setup(steps_per_epoch=CKPT_STEP)
    first, last = 0, RESUME_STEPS
    if phase == "part1":
        last = CKPT_STEP
    elif phase == "part2":
        trainer.restore(load_checkpoint(workdir / "ckpt"))
        first = CKPT_STEP
    for step in range(first, last):
        lb = trainer.train_step(local_rows(resume_batch(step)))
        assert np.isfinite(lb.total.item()), lb
    if phase == "part1":
        save_checkpoint(trainer.model, trainer.opt, trainer.step, epoch=1, batch_size=RESUME_BATCH,
                        save_path=workdir, filename="ckpt")
    print(f"DIGEST rank={distributed.rank()} phase={phase} {digest(trainer)}", flush=True)


def mode_train(argv: list) -> None:
    from tinyfaces_tpu_torch import main as cli
    from tinyfaces_tpu_torch.data import wider_face

    signal_rank = None
    if "--sigterm-rank" in argv:
        i = argv.index("--sigterm-rank")
        signal_rank = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    args = cli.arguments(argv)
    dataset = None
    if signal_rank == args.process_id:
        class SignalledOnce(wider_face.WIDERFace):
            """Sends SIGTERM to this process on its first decode (epoch 0)."""
            sent = False

            def _decode(self, idx):
                if not SignalledOnce.sent:
                    SignalledOnce.sent = True
                    os.kill(os.getpid(), signal.SIGTERM)
                return super()._decode(idx)

        dataset = SignalledOnce(args.traindata, load_templates(),
                                cfg=DetectorConfig(max_gt=args.max_gt),
                                dataset_root=args.dataset_root)
    trainer = cli.run(args, dataset, backend="gloo")
    print(f"STOPPED rank={args.process_id} step={trainer.step}", flush=True)


def mode_eval(argv: list) -> None:
    from tinyfaces_tpu_torch import evaluate_model

    evaluate_model.main(argv)
    print("EVAL_OK", flush=True)


def main() -> None:
    mode, store, world, rank, workdir, *rest = sys.argv[1:]
    torch.set_num_threads(1)
    detection.ARCHS["resnet50"] = dataclasses.replace(detection.ARCHS["resnet50"], stages=STAGES)
    if mode in ("step", "resume"):
        distributed.initialize(store, int(world), int(rank), device="cpu")
    if mode == "step":
        mode_step(Path(workdir))
    elif mode == "resume":
        mode_resume(Path(workdir), rest[0])
    elif mode == "train":
        mode_train(rest)
    elif mode == "eval":
        mode_eval(rest)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    distributed.barrier_at_exit(f"worker_{mode}_done")


if __name__ == "__main__":
    main()

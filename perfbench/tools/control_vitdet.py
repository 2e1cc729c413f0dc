"""The readings the ViTDet-B train cell's limits of `correct` were set from
(not run by the benchmark's own runs); tools/control.py's train half for
drivers/train_vitdet.py.

    python3 perfbench/tools/control_vitdet.py --workload train-vitdet-b8-1024 --seeds 1,2,3

For each seed it builds the cell's set-up as a run does and prints one JSON
line a seed: `program`, the port's three set-up steps and the window's
first (bfloat16 over float32 parameters, the captured step) through the
cell's own loader and Trainer against the float32 reference, as a run
compares them; then two controls, each the reference put in the port's
place through its model's hooks (reference/vitdet.py): `fp8`, every
tensor the detector stores rounded to float8 e4m3 (`quant`, the nearest
precision below the configuration's bfloat16), and `no_bias`, the
relative-position bias left out (`rel_pos=False`). A state left unchanged
reads 1 by construction (change_gap, window_gap) and needs no run.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.run import cache_env, load_cell  # noqa: E402

KEYS = ("aug_diff", "loss_gap", "update_gap", "change_gap", "window_gap", "change_gap_worst", "window_loss_gap")


def seed_readings(run) -> dict:
    from perfbench.drivers import train as base
    from perfbench.drivers import train_vitdet as drv
    from perfbench.reference import train as ref_train
    from perfbench.reference import vitdet_train as ref_vtrain
    from perfbench.reference.vitdet import fp8_e4m3

    root = Path(tempfile.mkdtemp(prefix="perfbench-control-", dir=run.tmpdir))
    try:
        env = drv.build(run, root)
        trainer = env["trainer"]
        prog, kept, batch = base.set_up_steps(run, env)
        before = {n: p.detach().clone() for n, p in base.trainable(trainer).items()}
        prog["losses"].append(float(trainer.train_step(batch).total))  # the window's first step
        prog["window"] = base.change_norms(base.trainable(trainer), before)
        del trainer, before, batch
        drv.release(env)
        nums, ref, batches = drv.check(run, env, root, prog, kept)
        out = {"program": {k: nums[k] for k in KEYS}}
        c = run.config
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        for name, kw in (("fp8", {"quant": fp8_e4m3}), ("no_bias", {"rel_pos": False})):
            other = ref_vtrain.run_steps(env["weights"], batches, env["seed"], base.reference_cfg(c),
                                         env["templates"], run.device, c["vit"], chunk=c["reference_chunk"],
                                         change_at=base.CHECK_STEPS, **kw)
            got = ref_train.numbers(other, ref)
            out[name] = {k: got[k] for k in KEYS if k in got}
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="train-vitdet-b8-1024")
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cache_env()
    _, _, config, traffic = load_cell(args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("the control is read on the card")
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = harness.Run(args.workload, config, traffic, seed=seed, seconds=1.0, trace=False,
                          devices=[torch.device("cuda", 0)], t_start=t0)
        row = seed_readings(run)
        row.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0,
                   card=harness.device_info(run, 0)["kind"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

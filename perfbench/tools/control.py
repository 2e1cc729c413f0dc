"""The readings the limits of `correct` were set from (not run by the
benchmark's own runs).

    python3 perfbench/tools/control.py --workload <cell> --seeds 1,2,3 [--program]

For each seed it builds the cell's set-up as a run does and prints, as one
JSON line a seed:

* eval cells: `control`, the numbers of the reference put in the port's
  place in the nearest precision below the configuration's (fp8 e4m3
  operands of every convolution for bf16), against the float32 reference,
  on `check_images` pool images; with `--program`, `program`: the port's
  own numbers on the same images, each from a batch of the cell's size
  through the timed entry (pack_inputs, detect_batch_async, _fetch);
* train cells: `program`, the port's first three steps and the window's
  first through the cell's own loader and Trainer against the reference
  (`aug_diff`: the loader's batches against the reference's redone from
  the files); `control`, the reference
  with TF32 on in the port's place; `half` and `leaf`, the reference with
  half the batch left out (the loss scaled to the whole batch) and with one
  leaf's first gradient doubled; `reorder`, the float32 reference in
  another memory layout (other kernels, another order of summation), the
  spread of rounding alone. A state left unchanged reads 1 by construction
  (change_gap, window_gap) and needs no run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench.run import cache_env, load_cell  # noqa: E402


def eval_seed(run, program: bool) -> dict:
    from perfbench.drivers import _shared
    from perfbench.reference.model import fp8_e4m3

    env = _shared.eval_setup(run)
    det, pool, t = env["det"], env["pool"], run.traffic
    picks = _shared.rng(run.seed, 7).choice(len(pool), size=min(t["check_images"], len(pool)),
                                             replace=False).tolist()
    out = {}
    if program:
        batch = t.get("batch", 1)
        items = []
        for s in range(0, len(picks), batch):
            idx = [picks[(s + j) % len(picks)] for j in range(batch)]
            res = det._fetch(det.detect_batch_async(det.pack_inputs([pool[i] for i in idx])))
            items += list(zip(idx, res))[: len(picks) - s]
        out["program"] = _shared.reference_numbers(run, env, items, explain=True)
    _shared.release(env)
    out["control"] = _shared.reference_numbers(run, env, [(i, None) for i in picks],
                                               quant=fp8_e4m3, explain=True)
    return out


def train_seed(run) -> dict:
    import tempfile
    import shutil

    from perfbench.drivers import train as drv
    from perfbench.reference import train as ref_train

    root = Path(tempfile.mkdtemp(prefix="perfbench-control-", dir=run.tmpdir))
    try:
        env = drv.build(run, root)
        trainer = env["trainer"]
        prog, kept, batch = drv.set_up_steps(run, env)
        before = {n: p.detach().clone() for n, p in drv.trainable(trainer).items()}
        prog["losses"].append(float(trainer.train_step(batch).total))  # the window's first step
        prog["window"] = drv.change_norms(drv.trainable(trainer), before)
        env["batches"].close()
        for k in ("trainer", "loader", "batches", "dataset"):
            del env[k]
        del trainer, before, batch
        out = {}
        out["program"], ref, batches = drv.check(run, env, root, prog, kept)
        w, stages, tmpl, seed = env["weights"], env["stages"], env["templates"], env["seed"]
        cfg = drv.reference_cfg(run.config)

        def reading(**kw):
            other = ref_train.run_steps(w, batches, seed, cfg, tmpl, run.device, stages,
                                        change_at=drv.CHECK_STEPS, **kw)
            return ref_train.numbers(other, ref)

        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            out["control"] = reading()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        out["reorder"] = reading(channels_last=True)
        for fault in ("half", "leaf"):
            out[fault] = reading(fault=fault)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None, *, tiny_device=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--dtype", default="", help="run the port at this dtype (a witness)")
    ap.add_argument("--wire", default="", help="run the port on this wire (a witness)")
    args = ap.parse_args(argv)
    cache_env()
    if tiny_device is None:
        bench, cell, config, traffic = load_cell(args.workload, unlisted=True)
        if not torch.cuda.is_available():
            raise SystemExit("the control is read on the card")
        device = torch.device("cuda", 0)
    else:
        from perfbench.tests.tiny import tiny

        bench, cell, config, traffic = tiny(args.workload)
        device = tiny_device
    config, traffic = dict(config), dict(traffic)
    config.update({k: v for k, v in (("dtype", args.dtype), ("wire", args.wire)) if v})
    rows = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = harness.Run(args.workload, config, traffic, seed=seed, seconds=1.0, trace=False,
                          devices=[device], t_start=t0)
        row = train_seed(run) if traffic["driver"] == "train" else eval_seed(run, args.program)
        row.update(workload=args.workload, seed=seed, dtype=config.get("dtype"), wire=config.get("wire"),
                   seconds=time.perf_counter() - t0,
                   card=harness.device_info(run, 0)["kind"])
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()

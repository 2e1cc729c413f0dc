"""The training loop `main.py --num_processes N` users run, over N cards of
one host: N processes, one card each, on the port's data-parallel path
(`parallel/distributed.py` over NCCL: `--batch_size` is the global batch,
each rank loads and trains its rows of it, every training BatchNorm merges
its statistics over the ranks, the gradients and the losses are
all-reduced). Each rank runs drivers/train.py's loop: `NativePrefetchLoader`
with the traffic's workers feeding `Trainer.train_step`. Under a process
group the step is the eager one (the collectives are not captured).

Rank 0 is the harness's process and keeps the clock: it writes the tree,
starts ranks 1..N-1 as child processes of this module (`python -m
perfbench.drivers.train_dp --child SPEC --rank r`), and decides before each
step whether another step runs, a flag it broadcasts over a gloo group of
the same ranks, so every rank runs the same steps. It reads the loss every
step, as the CLI at `--log-every 1`. The process group's start and every
collective have the traffic's `timeout_s`; a watchdog thread on rank 0
kills every rank when a child fails, and each child dies with rank 0
(PR_SET_PDEATHSIG), so the run ends, failed, and never hangs.

The check: every rank saves the rows of the four batches it trained on
(three set-up steps, the window's first); rank 0 joins them into the global
batches, and drivers/train.check redoes those from the files and follows
the four steps on the global batch of `batch_size` rows from the seeded
weights: world N's merged BatchNorm statistics equal one process's over the
same rows. The configuration's own `limits` decide (`aug_diff`,
`loss_gap`, `update_gap`, `change_gap`, `window_gap`).

No cell of BENCHMARK.json runs this driver yet: under the ResNet
configuration's limits, set from one card, four ranks read `update_gap`
7.1e-4-1.3e-3 on every seed (1e-4 allowed), the rounding of a four-way
split of the batch's reductions that ResNet-101's backward amplifies
(PERF.md); its cell waits for limits of its own.

`train_img_per_s`: the global images of the steps whose loss rank 0 read
within the window over the time from its start to the last such read. The
trace is rank 0's process.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from perfbench import harness  # noqa: E402
from perfbench import weights as W  # noqa: E402
from perfbench.drivers import train as drv  # noqa: E402
from perfbench.drivers._shared import rng  # noqa: E402
from perfbench.drivers.train_vitdet import log_loader  # noqa: E402
from perfbench.traffic import generate  # noqa: E402


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class _Child:
    """What drivers/train.py's helpers read of a run, on ranks 1..N-1."""

    def __init__(self):
        self.spans = harness.Spans(False)


def rank_env(spec: dict, rank: int, device: torch.device) -> dict:
    """Join the process group, then build this rank's Trainer and loader on
    the shared tree (drivers/train.build's, on this rank's rows)."""
    from tinyfaces_tpu_torch.config import DetectorConfig, TrainConfig
    from tinyfaces_tpu_torch.data.loader import NativePrefetchLoader
    from tinyfaces_tpu_torch.data.wider_face import WIDERFace
    from tinyfaces_tpu_torch.models.detection import TinyFacesDetector
    from tinyfaces_tpu_torch.trainer import Trainer

    c, t = spec["config"], spec["traffic"]
    world, timeout = t["ranks"], datetime.timedelta(seconds=t["timeout_s"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{spec['port']}", world_size=world, rank=rank,
                            timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=timeout)
    stages = tuple(c["stage_sizes"])
    templates = np.asarray(c["templates"], np.float64)
    weights = W.make(spec["seed"], device, stages, len(templates))
    if not c["tf32"]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = DetectorConfig(num_templates=len(templates), input_size=tuple(c["input_size"]),
                         heatmap_size=tuple(c["heatmap_size"]), pos_thresh=c["pos_thresh"],
                         neg_thresh=c["neg_thresh"], pos_fraction=c["pos_fraction"],
                         sample_size=c["sample_size"], hard_neg_loss_thresh=c["hard_neg_thresh"],
                         max_gt=c["max_gt"])
    tc = TrainConfig(lr=c["lr"], momentum=c["momentum"], weight_decay=c["weight_decay"],
                     batch_size=c["batch_size"], workers=t["workers"])
    root = Path(spec["root"])
    dataset = WIDERFace(Path(spec["ann"]), templates, cfg=cfg, dataset_root=root, split="train")
    model = TinyFacesDetector(num_templates=len(templates), stage_sizes=stages, dtype=None)
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    seed = spec["seed"] % 2**63
    trainer = Trainer(model=model, cfg=cfg, tc=tc, templates=templates, device=device, seed=seed,
                      augment="native", transfer=c["wire"])
    trainer.setup(max(1, len(dataset) // tc.batch_size))
    loader = NativePrefetchLoader(dataset, tc.batch_size, device=device, workers=t["workers"], seed=seed,
                                  epoch=0, pack=c["wire"], rank=rank, world=world)
    return {"weights": weights, "trainer": trainer, "loader": loader, "batches": iter(loader),
            "stages": stages, "templates": templates, "seed": seed, "dataset": dataset,
            "ann": Path(spec["ann"]), "control": control}


def agree(go: bool, env: dict) -> bool:
    """Rank 0's decision whether another step runs, on every rank."""
    flag = torch.tensor([int(go)], dtype=torch.int32)
    dist.broadcast(flag, 0, group=env["control"])
    return bool(flag.item())


def save_rows(kept: list, path: Path) -> None:
    torch.save([{k: v.detach().cpu() for k, v in b.items()} for b in kept], path)


def child(spec_path: str, rank: int) -> None:
    """Rank `rank` of the run (never 0): the set-up steps, its rows saved,
    then the steps rank 0 calls for."""
    spec = json.loads(Path(spec_path).read_text())
    device = torch.device(spec["device_type"], rank) if spec["device_type"] == "cuda" else torch.device("cpu")
    run = _Child()
    env = rank_env(spec, rank, device)
    _, kept, batch = drv.set_up_steps(run, env)
    save_rows(kept, Path(spec["root"]) / f"rows_{rank}.pt")
    trainer = env["trainer"]
    go = agree(False, env)
    while go:
        trainer.train_step(batch)
        batch = drv.next_batch(run, env)
        go = agree(False, env)
    leave(env, device)
    env["batches"].close()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)  # no interpreter teardown: the loader's threads go with the process


def leave(env: dict, device: torch.device) -> None:
    """Every rank, after its last step: its card drained, a barrier, then
    out of the process group (as the port's `barrier_at_exit`)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier(group=env["control"])
    dist.destroy_process_group()


def _die_with_parent() -> None:
    try:
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except OSError:
        pass


class Ranks:
    """Ranks 1..N-1 as child processes, and the watchdog that ends the run
    when one of them fails."""

    def __init__(self, spec_path: Path, world: int, root: Path):
        self.done = threading.Event()
        self.logs = [root / f"rank_{r}.log" for r in range(1, world)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")]))
        self.procs = []
        for r, path in zip(range(1, world), self.logs):
            with open(path, "wb") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "perfbench.drivers.train_dp", "--child", str(spec_path),
                     "--rank", str(r)], cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                    preexec_fn=_die_with_parent))
        self.thread = threading.Thread(target=self._watch, name="train_dp watchdog", daemon=True)
        self.thread.start()

    def tail(self, r: int) -> str:
        return self.logs[r - 1].read_bytes()[-4000:].decode(errors="replace")

    def _watch(self) -> None:
        while not self.done.wait(0.5):
            for r, p in enumerate(self.procs, start=1):
                rc = p.poll()
                if rc is not None and rc != 0:
                    print(f"perfbench: rank {r} exited with {rc}; its log:\n{self.tail(r)}", file=sys.stderr,
                          flush=True)
                    self.kill()
                    os._exit(1)

    def wait(self, timeout: float) -> None:
        """Every child's clean exit (then the watchdog stops)."""
        deadline = time.monotonic() + timeout
        for r, p in enumerate(self.procs, start=1):
            rc = p.wait(max(1.0, deadline - time.monotonic()))
            if rc != 0:
                raise RuntimeError(f"rank {r} exited with {rc}:\n{self.tail(r)}")
        self.done.set()

    def kill(self) -> None:
        self.done.set()
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            try:
                p.wait(10)
            except subprocess.TimeoutExpired:
                pass


def run(run: harness.Run) -> None:
    root = Path(tempfile.mkdtemp(prefix="perfbench-dp-", dir=run.tmpdir))
    try:
        _run(run, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(run: harness.Run, root: Path) -> None:
    c, t = run.config, run.traffic
    world = t["ranks"]
    if run.device.type == "cuda" and len(run.devices) < world:
        raise RuntimeError(f"{world} ranks need {world} cards, the run has {len(run.devices)}")
    t0 = time.perf_counter()
    ann, summary = generate.wider_tree(rng(run.seed, 5), root, t)
    run.log(f"set-up: train tree {summary} in {time.perf_counter() - t0:.2f} s")
    spec = {"config": c, "traffic": t, "seed": run.seed, "root": str(root), "ann": str(ann),
            "port": free_port(), "device_type": run.device.type}
    spec_path = root / "spec.json"
    spec_path.write_text(json.dumps(spec))
    ranks = Ranks(spec_path, world, root)
    try:
        _rank0(run, spec, root, ranks)
    finally:
        ranks.kill()  # a failed run's process group goes with the process


def _rank0(run: harness.Run, spec: dict, root: Path, ranks: Ranks) -> None:
    c, t = run.config, run.traffic
    world = t["ranks"]
    env = rank_env(spec, 0, run.device)
    trainer = env["trainer"]
    prog, kept, batch = drv.set_up_steps(run, env)
    params = drv.trainable(trainer)
    before = {n: p.detach().clone() for n, p in params.items()}
    after = {n: torch.empty_like(p) for n, p in params.items()}
    first_loss = None
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.spans.durations.clear()
    t0 = run.begin_window()
    deadline = run.deadline()
    steps, t_last = 0, t0
    go = agree(time.perf_counter() < deadline, env)
    while go:
        with run.spans("train_step"):
            lb = trainer.train_step(batch)
        if first_loss is None:  # the window's first step, kept for the check
            torch._foreach_copy_(list(after.values()), list(params.values()))
            first_loss = lb.total
        run.attempted += 1
        batch = drv.next_batch(run, env)
        go = agree(time.perf_counter() < deadline, env)
        with run.spans("loss_read"):
            total = float(lb.total)
            float(lb.class_loss), float(lb.reg_loss)
        now = time.perf_counter()
        if now <= deadline:
            steps += 1
            t_last = now
            if not math.isfinite(total):
                run.failed += 1
    leave(env, run.device)
    run.end_window()
    run.counters["memory_peak_bytes"] = harness.memory_peak([run.device])
    b = c["batch_size"]
    if not steps:
        raise RuntimeError("no step completed within the window")
    run.e2e["train_img_per_s"] = steps * b / (t_last - t0)
    run.counters["window_steps"] = run.attempted
    run.log(f"window: {steps} steps of {b} over {world} ranks in {t_last - t0:.3f} s, "
            f"{run.e2e['train_img_per_s']:.4f} img/s; peak (rank 0) {run.counters['memory_peak_bytes']} B; "
            + ", ".join(f"{k} {1e3 * np.mean(v):.2f} ms (max {1e3 * max(v):.2f}; medians by thirds "
                        + "/".join(f"{1e3 * np.median(x):.2f}" for x in np.array_split(v, 3) if len(x)) + ")"
                        for k, v in run.spans.durations.items() if v))
    log_loader(run)
    prog["losses"].append(float(first_loss))
    prog["window"] = drv.change_norms(after, before)
    env["batches"].close()
    for k in ("trainer", "loader", "batches", "dataset"):
        del env[k]
    del trainer, params, before, after, lb, batch
    ranks.wait(t["timeout_s"])
    rows = [kept] + [torch.load(root / f"rows_{r}.pt", weights_only=True) for r in range(1, world)]
    global_kept = [{k: torch.cat([r[s][k].cpu() for r in rows]) for k in kept[s]} for s in range(len(kept))]
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    nums, ref, _ = drv.check(run, env, root, prog, global_kept)
    for k in ("aug_diff", "loss_gap", "update_gap", "change_gap", "window_gap"):
        run.checks.append((k, nums[k], c["limits"][k]))
    run.log(f"reference check of {len(kept)} steps on the global batch of {b}: {time.perf_counter() - t1:.2f} s; "
            f"losses program {prog['losses']} reference {ref['losses']}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank (never 0) of a train_dp run")
    ap.add_argument("--child", required=True)
    ap.add_argument("--rank", type=int, required=True)
    a = ap.parse_args()
    child(a.child, a.rank)

"""AP cost of the production eval defaults, through the port.

    python -m tinyfaces_tpu_torch.tools.ap_cost --workdir E2E_WORKDIR --epochs 24 \\
        [--device cuda]

The reference evaluates on exact PIL-decoded fp32 pixels; the production
default is bf16 + the lossy jpegdct wire (evaluate_model). This tool
bounds that deviation in AP: one trained checkpoint, one val tree, four
configurations through the same sweep and grader (parity_run, each in a
child process):

    fp32+rgb+pil        — the reference-exact protocol (parity_run defaults)
    fp32+rgb+linear     — isolates the resampling-kernel delta
    bf16+rgb+pil        — isolates the precision delta
    bf16+jpegdct+linear — the production default (evaluate_model defaults)

Writes <workdir>/AP_COST.json (or --out): per configuration the AP per
split, img/s and the delta against fp32+rgb+pil. Pointed at an
e2e_accuracy workdir (checkpoint and held-out val tree already there).

The port of tools/ap_cost.py.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from tinyfaces_tpu_torch.tools.train_soak import child_env

CONFIGS = [
    ("fp32+rgb+pil", ["--transfer", "rgb", "--resample", "pil"]),
    ("fp32+rgb+linear", ["--transfer", "rgb", "--resample", "linear"]),
    ("bf16+rgb+pil", ["--transfer", "rgb", "--resample", "pil", "--bf16"]),
    ("bf16+jpegdct+linear", ["--transfer", "jpegdct", "--resample", "linear", "--bf16"]),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True,
                    help="e2e_accuracy workdir: uses <workdir>/wider and "
                         "<workdir>/weights/checkpoint_<epochs>")
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--checkpoint", default="", help="override checkpoint path")
    ap.add_argument("--eval-batch", type=int, default=32)
    ap.add_argument("--prob-thresh", type=float, default=0.03)
    ap.add_argument("--arch", default="resnet101")
    ap.add_argument("--out", default="", help="default <workdir>/AP_COST.json")
    ap.add_argument("--device", default="cuda", help="device of the child runs (cuda or cpu)")
    args = ap.parse_args(argv)

    workdir = Path(args.workdir).resolve()  # the children run in it
    ckpt = Path(args.checkpoint).resolve() if args.checkpoint else (
        workdir / "weights" / f"checkpoint_{args.epochs}")
    if not ckpt.exists():
        raise SystemExit(f"checkpoint not found: {ckpt}")
    tree = workdir / "wider"

    rows = {}
    for name, flags in CONFIGS:
        out = workdir / f"ap_{name.replace('+', '_')}.json"
        cmd = [sys.executable, "-m", "tinyfaces_tpu_torch.tools.parity_run",
               "--dataset-root", str(tree), "--checkpoint", str(ckpt),
               "--arch", args.arch, "--ab-images", "0",
               "--prob_thresh", str(args.prob_thresh),
               "--eval-batch", str(args.eval_batch),
               "--out", str(out), "--device", args.device, *flags]
        print(f"[ap-cost] {name}: {' '.join(cmd)}", flush=True)
        t0 = time.time()
        rc = subprocess.run(cmd, cwd=workdir, env=child_env()).returncode
        if rc != 0:
            raise SystemExit(f"parity_run failed for {name} (rc={rc})")
        data = json.loads(out.read_text())
        rows[name] = {
            "ap": {k: float(v) for k, v in data["scores"].items()},
            "images_per_sec": data.get("images_per_sec"),
            "images_per_sec_steady": data.get("images_per_sec_steady"),
            "device": data.get("device"),
            "wall_s": round(time.time() - t0, 1),
        }
        print(f"[ap-cost] {name}: {rows[name]['ap']} "
              f"({rows[name]['images_per_sec']} img/s)", flush=True)

    ref = rows["fp32+rgb+pil"]["ap"]
    for row in rows.values():
        row["delta_vs_reference_exact"] = {k: row["ap"][k] - ref[k] for k in ref}

    default_cost = rows["bf16+jpegdct+linear"]["delta_vs_reference_exact"]
    payload = {
        "checkpoint": str(ckpt),
        "splits": "approximate height-band (synthetic val tree)",
        "configs": rows,
        "production_default_ap_cost": default_cost,
        "acceptable": all(abs(v) <= 0.005 for v in default_cost.values()),
        "note": "if the production default costs > 0.005 AP on any split, the eval "
                "default should go back to fp32+rgb (evaluate_model).",
    }
    out = Path(args.out or workdir / "AP_COST.json")
    out.write_text(json.dumps(payload, indent=1) + "\n")
    print(f"[ap-cost] wrote {out}", flush=True)
    return payload


if __name__ == "__main__":
    main()

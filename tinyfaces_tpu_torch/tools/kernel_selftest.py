"""On-card self-test of the compiled K1 kernel against the plain assignment.

    python -m tinyfaces_tpu_torch.tools.kernel_selftest [--batch 12] [--gt 192] [--device cuda]

Port of tools/tpu_selftest.py, which held the compiled Pallas kernel
against the XLA broadcast path on a chip. Here the compiled CUDA kernel
(ops/assignment_kernel.py, csrc/dense_assignment.cu) runs inside
`assign_targets_fused` on the card, and the non-fused path is the plain
twin `dense_assignment_reductions_reference` on the same card, which
materializes the (B, 63, 63, 25, G) IoU tensor, followed by the same
`compose_targets`. The inputs are the JAX tool's: 5-60 GT boxes per image
drawn with NumPy seed 0, the full 500x500 crop's border mask.

  * labels: with each path's own tie-break noise (the kernel's hash, the
    twin's torch.rand) they differ only at tie-noise level (mismatch rate
    < 1e-3, the JAX tool's bound); with the twin fed the kernel's draws
    (kernel_noise) the labels are equal;
  * regression targets: equal within 1e-3 on the positives both agree on;
  * times: the kernel path and the plain path per batch (CUDA events,
    median of `--iters`), with the card's name and power limit.

Prints `SELFTEST PASS` or `SELFTEST FAIL` and a JSON line; exits 1 on a
failure. The kernel runs on a card only: `--device cpu` exits.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

RF = dict(ofx=-1.0, ofy=-1.0, stx=8.0, sty=8.0)


def scene(batch: int, g: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """tools/tpu_selftest.py's GT boxes (B, G, 4) and valid mask (B, G)."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((batch, g, 4), np.float32)
    valid = np.zeros((batch, g), bool)
    for b in range(batch):
        n = int(rng.integers(5, 60))
        x1 = rng.uniform(0, 450, n)
        y1 = rng.uniform(0, 450, n)
        gt[b, :n] = np.stack([x1, y1, x1 + rng.uniform(8, 120, n), y1 + rng.uniform(8, 120, n)], 1)
        valid[b, :n] = True
    return gt, valid


def selftest(dev: torch.device, batch: int = 12, g: int = 192, iters: int = 20) -> dict:
    from tinyfaces_tpu_torch.config import DetectorConfig
    from tinyfaces_tpu_torch.data import load_templates
    from tinyfaces_tpu_torch.ops import assignment_kernel as ak
    from tinyfaces_tpu_torch.ops.assignment import compose_targets, compute_pad_mask
    from tinyfaces_tpu_torch.utils.instruments import cuda_events_ms

    cfg = DetectorConfig()
    vsy, vsx = cfg.heatmap_size
    templates = torch.tensor(load_templates(), dtype=torch.float32, device=dev)
    gt_np, valid_np = scene(batch, g)
    gt, valid = torch.from_numpy(gt_np).to(dev), torch.from_numpy(valid_np).to(dev)
    pad = compute_pad_mask(torch.tensor([[0.0, 0.0, 500.0, 500.0]] * batch, device=dev),
                           templates, vsx=vsx, vsy=vsy, flip=torch.zeros(batch, dtype=torch.bool,
                                                                         device=dev), **RF)
    thresholds = dict(pos_thresh=cfg.pos_thresh, neg_thresh=cfg.neg_thresh)
    seeds = torch.arange(batch, dtype=torch.int32, device=dev) * 7919 + 1
    valid_g = ak.drop_degenerate(gt, valid)

    def kernel_path():
        red = ak.dense_assignment_reductions(gt, valid_g, templates, seeds, vsx=vsx, vsy=vsy, **RF)
        return compose_targets(*red, gt, valid_g, pad, templates, **thresholds, **RF)

    def plain_path(noise_tensor=None):
        red = ak.dense_assignment_reductions_reference(gt, valid_g, templates, seeds, vsx=vsx,
                                                       vsy=vsy, noise_tensor=noise_tensor, **RF)
        return compose_targets(*red, gt, valid_g, pad, templates, **thresholds, **RF)

    ck, rk = kernel_path()
    cp, rp = plain_path()
    cm, _ = plain_path(ak.kernel_noise(seeds, vsy, vsx, templates.shape[0], g))
    mismatch = float((ck != cp).float().mean())
    agree = torch.cat([(ck == cp) & (ck > 0)] * 4, dim=3)
    reg_diff = float((rk - rp).abs()[agree].max()) if bool(agree.any()) else 0.0
    out = {"batch": batch, "gt": g, "label_mismatch_rate": mismatch,
           "labels_equal_with_kernel_noise": bool(torch.equal(ck, cm)),
           "regression_max_diff_on_agreeing_positives": reg_diff,
           "positives_kernel": int((ck == 1).sum()), "positives_plain": int((cp == 1).sum()),
           "kernel_ms": cuda_events_ms(kernel_path, iters),
           "plain_ms": cuda_events_ms(plain_path, iters)}
    out["ok"] = mismatch < 1e-3 and reg_diff < 1e-3 and out["labels_equal_with_kernel_noise"]
    return out


def main(argv=None) -> dict:
    from tinyfaces_tpu_torch.utils.instruments import card, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--gt", type=int, default=192, help="padded GT slots per image")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="the card (cuda or cuda:N)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit(f"--device {args.device}: the self-test runs the compiled kernel on a card")
    out = {"card": card(dev), **selftest(dev, args.batch, args.gt, args.iters)}
    print(f"label mismatch rate: {out['label_mismatch_rate']:.2e} (tie-noise only; expect <1e-3); "
          f"equal with the kernel's draws: {out['labels_equal_with_kernel_noise']}")
    print(f"regression max diff on agreeing positives: "
          f"{out['regression_max_diff_on_agreeing_positives']:.2e}")
    print(f"positives: kernel={out['positives_kernel']} plain={out['positives_plain']}")
    print(f"kernel: {out['kernel_ms']:.3f} ms/batch, plain: {out['plain_ms']:.3f} ms/batch "
          f"({out['card']})")
    print("SELFTEST", "PASS" if out["ok"] else "FAIL")
    print(json.dumps(out))
    if not out["ok"]:
        sys.exit(1)
    return out


if __name__ == "__main__":
    main()

"""The reference's train step for the ViTDet-B detector (reference/vitdet.py),
in float32: the targets, the loss, each step's draws and the numbers that
decide `correct` are reference/train.py's, taken by import; only the model
differs.

A step's batch may run in chunks of images: the ViT has no batch norm, the
loss is a sum over the batch whose hard-negative mining and balance sampling
work image by image (with each image's own draws), so the chunks' gradients,
summed, are the batch's exactly. That is how the 1024x1024 batch of 8 fits on
one card with the attention's scores held in float32.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from perfbench.reference import train as ref_train
from perfbench.reference.vitdet import VITDET_B, VitDet


def run_steps(weights: dict, batches: list, seed: int, cfg: dict, templates: np.ndarray, device,
              arch: dict = VITDET_B, *, chunk: int = 2, quant: Optional[Callable] = None,
              rel_pos: bool = True, change_at: Optional[int] = None) -> dict:
    """The reference's first len(batches) steps from `weights` (copied),
    `chunk` images at a time; returns what reference/train.run_steps
    returns. `quant` and `rel_pos` go to the model (reference/vitdet.py):
    the controls' lower precision and missing bias."""
    w = {k: v.detach().clone().to(device) for k, v in weights.items()}
    names = [n for n in w if ref_train.trainable(n)]
    for n in names:
        w[n].requires_grad_(True)
    start = {n: w[n].detach().clone() for n in names}
    model = VitDet(w, arch, quant=quant, rel_pos=rel_pos)
    tmpl = torch.tensor(templates, dtype=torch.float32, device=device)
    vsy, vsx = cfg["heatmap_size"]
    anchors = vsy * vsx * cfg["num_templates"]
    mom: dict = {}
    change_at = len(batches) if change_at is None else change_at
    out = {"losses": [], "grad": {}, "update": {}, "change": {}, "window": {}, "change_at": change_at}
    params = [w[n] for n in names]
    for step, batch in enumerate(batches):
        if step == len(batches) - 1:
            before = {n: w[n].detach().clone() for n in names}
        rows = batch["gt_boxes"].shape[0]
        dr = ref_train.step_draws(seed, step, rows, anchors, device)
        cls_map, reg_map = ref_train.targets(batch, tmpl, cfg, dr["seeds"])
        grads, total = None, 0.0
        for s in range(0, rows, chunk):
            sl = slice(s, min(rows, s + chunk))
            x = ref_train.normalise(batch["image"][sl].to(device))
            o = model.forward(x).permute(0, 2, 3, 1)
            lv = ref_train.loss(o, cls_map[sl], reg_map[sl], {"pos": dr["pos"][sl], "neg": dr["neg"][sl]}, cfg)
            g = torch.autograd.grad(lv, params, allow_unused=True)  # no bias: its tables unused
            g = tuple(torch.zeros_like(p) if gi is None else gi for p, gi in zip(params, g))
            grads = g if grads is None else tuple(a + b for a, b in zip(grads, g))
            total += float(lv.detach())
            del o, lv, g, x
        out["losses"].append(total)
        with torch.no_grad():
            for n, g in zip(names, grads):
                d = g + cfg["weight_decay"] * w[n]
                if step == 0:
                    out["grad"][n] = float(g.norm())
                    out["update"][n] = float(d.norm())
                    mom[n] = d.clone()
                else:
                    mom[n].mul_(cfg["momentum"]).add_(d)
                w[n].sub_(cfg["lr"] * ref_train.group_factor(n) * mom[n])
            if step + 1 == change_at:
                out["change"] = {n: float((w[n] - start[n]).norm()) for n in names}
        del grads, cls_map, reg_map, dr
    with torch.no_grad():
        out["window"] = {n: float((w[n] - before[n]).norm()) for n in names}
    return out

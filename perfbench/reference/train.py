"""The reference's train step (reference `trainer.py`, `loss.py`,
`processor.py`, `models/utils.py`), in float32, and the numbers that
decide a train cell's `correct`.

Targets: each anchor (63 x 63 cells x 25 templates, the receptive field's
stride 8 and offset -1) is held against every valid ground truth (zero- or
negative-extent boxes dropped) by IoU with the +1 pixel convention, plus a
tie-break draw under 1e-6 (the port's hash of the image's seed, anchor and
ground truth, `kernel_noise`, frozen here); invalid ground truths read -1.
Each ground truth's best anchor is positive if its IoU exceeds neg_thresh
(0.3); anchors at pos_thresh (0.7) or above are positive; [0.3, 0.7) is
ignored; the rest negative; with no ground truth all negative; anchors that
cross the pasted crop's border and are not negative are ignored and their
tx target zeroed. Regression targets are the best ground truth's centre
offsets over the template's size and log size ratios.

Loss: soft-margin over labels that hard-negative mining (loss under 0.03
ignored) and balance sampling (at most 128 positives and 128 negatives an
image, kept where their uniform draws are smallest) leave, plus smooth-L1
over the positives' four regression blocks, summed. SGD: decay 5e-4 added
to the gradient, momentum 0.9 (the buffer starts at the first step's
gradient), learning rate 1e-4, x0.1 for `score_res3`; the upsample is
frozen. Each step's draws come from a generator seeded with (seed, step):
K1's per-image seeds, then the positive and the negative uniforms.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.model import Detector

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
_M32 = 0xFFFFFFFF


def _mul32(h, c):
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kernel_noise(seed: int, vsy: int, vsx: int, t: int, g: int, device) -> torch.Tensor:
    """(vsy, vsx, t, g) float32 draws in [0, 1e-6): the 24 high bits of
    fmix32(fmix32(fmix32(seed ^ C0) ^ anchor) + g * C1) times 2**-24 * 1e-6."""
    anchors = torch.arange(vsy * vsx * t, dtype=torch.int64, device=device)
    gkey = _mul32(torch.arange(g, dtype=torch.int64, device=device), 0x9E3779B9)
    s = _fmix32(torch.tensor((seed & _M32) ^ 0x7F4A7C15, dtype=torch.int64, device=device))
    bits = _fmix32((_fmix32(s ^ anchors)[:, None] + gkey[None, :]) & _M32) >> 8
    unit = torch.tensor(1e-6 * 2.0 ** -24, dtype=torch.float32, device=device)
    return (bits.to(torch.float32) * unit).reshape(vsy, vsx, t, g)


def step_draws(seed: int, step: int, rows: int, anchors: int, device) -> dict:
    s = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device).manual_seed(int(s))
    seeds = torch.randint(0, 2**31 - 1, (rows,), generator=gen, device=device, dtype=torch.int32)
    pos = torch.rand((rows, anchors), generator=gen, device=device)
    neg = torch.rand((rows, anchors), generator=gen, device=device)
    return {"seeds": seeds, "pos": pos, "neg": neg}


def targets(batch: dict, templates: torch.Tensor, cfg: dict, seeds: torch.Tensor):
    """(class map (B, Y, X, T), regression map (B, Y, X, 4T))."""
    dev = templates.device
    vsy, vsx = cfg["heatmap_size"]
    st, of = float(cfg["rf_stride"]), float(cfg["rf_offset"])
    gt = batch["gt_boxes"].to(dev, torch.float32)
    valid = batch["gt_valid"].to(dev, torch.bool)
    valid = valid & ~((gt[..., 2] <= gt[..., 0]) | (gt[..., 3] <= gt[..., 1]))
    b, g, _ = gt.shape
    nt = templates.shape[0]
    tp = templates[:, :4]
    cx = of + torch.arange(vsx, dtype=torch.float32, device=dev) * st
    cy = of + torch.arange(vsy, dtype=torch.float32, device=dev) * st
    farea = (tp[:, 2] - tp[:, 0] + 1.0) * (tp[:, 3] - tp[:, 1] + 1.0)
    cls_maps, reg_maps = [], []
    for i in range(b):
        bx = gt[i]
        barea = (bx[:, 2] - bx[:, 0] + 1.0) * (bx[:, 3] - bx[:, 1] + 1.0)
        iw = (torch.minimum(cx[:, None, None] + tp[None, :, 2, None], bx[None, None, :, 2])
              - torch.maximum(cx[:, None, None] + tp[None, :, 0, None], bx[None, None, :, 0]) + 1.0)
        ih = (torch.minimum(cy[:, None, None] + tp[None, :, 3, None], bx[None, None, :, 3])
              - torch.maximum(cy[:, None, None] + tp[None, :, 1, None], bx[None, None, :, 1]) + 1.0)
        inter = ih[:, None] * iw[None, :]  # (Y, X, T, G)
        ok = (ih[:, None] > 0) & (iw[None, :] > 0)
        iou = torch.where(ok, inter / (farea[None, None, :, None] + barea - inter), 0.0)
        iou = torch.where(valid[i], iou, 0.0)
        iou = iou + kernel_noise(int(seeds[i]), vsy, vsx, nt, g, dev)
        iou = torch.where(valid[i], iou, -1.0)
        gidx = torch.arange(g, device=dev)
        best = iou.max(-1).values
        best_gt = torch.where(iou == best[..., None], gidx, g).min(-1).values
        flat = iou.reshape(-1, g)
        pmax = flat.max(0).values
        aidx = torch.arange(flat.shape[0], device=dev)[:, None]
        pidx = torch.where(flat == pmax[None], aidx, flat.shape[0]).min(0).values
        n = flat.shape[0]
        force = (pmax > cfg["neg_thresh"]) & valid[i]
        forced = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        forced[torch.where(force, pidx, n)] = True
        forced = forced[:n].reshape(vsy, vsx, nt)
        cm = torch.where(forced, 1.0, -1.0)
        cm = torch.maximum(cm, (best >= cfg["pos_thresh"]) * 2.0 - 1.0)
        cm = torch.maximum(cm, torch.where((best >= cfg["neg_thresh"]) & (best < cfg["pos_thresh"]), 0.0, -1.0))
        anygt = bool(valid[i].any())
        if not anygt:
            cm = torch.full_like(cm, -1.0)
        sel = bx[best_gt.clamp(max=g - 1)]  # (Y, X, T, 4)
        fcx, fcy = (sel[..., 0] + sel[..., 2]) / 2.0, (sel[..., 1] + sel[..., 3]) / 2.0
        fw, fh = sel[..., 2] - sel[..., 0] + 1.0, sel[..., 3] - sel[..., 1] + 1.0
        dw, dh = tp[:, 2] - tp[:, 0] + 1.0, tp[:, 3] - tp[:, 1] + 1.0
        tx = (fcx - cx[None, :, None]) / dw
        ty = (fcy - cy[:, None, None]) / dh
        tw, th = torch.log(fw / dw), torch.log(fh / dh)
        pb = batch["paste_box"][i].to(dev, torch.float32)
        cross = ((cx[None, :, None] + tp[None, None, :, 0] < pb[0] + 1)
                 | (cy[:, None, None] + tp[None, None, :, 1] < pb[1] + 1)
                 | (cx[None, :, None] + tp[None, None, :, 2] > pb[2])
                 | (cy[:, None, None] + tp[None, None, :, 3] > pb[3]))
        if bool(batch["flip"][i]):
            cross = cross.flip(1)
        border = cross & (cm != -1.0)
        cm = torch.where(border, 0.0, cm)
        tx = torch.where(border, 0.0, tx)
        reg = torch.cat([tx, ty, tw, th], -1)
        if not anygt:
            reg = torch.zeros_like(reg)
        cls_maps.append(cm)
        reg_maps.append(reg)
    return torch.stack(cls_maps), torch.stack(reg_maps)


def _keep_k(cand: torch.Tensor, k: int, u: torch.Tensor) -> torch.Tensor:
    if k >= cand.shape[1]:
        return cand
    ranked = torch.where(cand, u, torch.inf)
    kth = torch.topk(ranked, k, dim=1, largest=False).values.amax(1, keepdim=True)
    return cand & (ranked <= kth)


def loss(out_nhwc: torch.Tensor, cls_map, reg_map, draws: dict, cfg: dict) -> torch.Tensor:
    nt = cfg["num_templates"]
    logits, reg = out_nhwc[..., :nt], out_nhwc[..., nt:]
    with torch.no_grad():
        lab = torch.where(F.softplus(-cls_map * logits.detach()) < cfg["hard_neg_thresh"], 0.0, cls_map)
        flat = lab.reshape(lab.shape[0], -1)
        pos_max = int(cfg["sample_size"] * cfg["pos_fraction"])
        neg_max = int(pos_max * (1 - cfg["pos_fraction"]) / cfg["pos_fraction"])
        pos, neg = flat == 1.0, flat == -1.0
        flat = torch.where(pos & ~_keep_k(pos, pos_max, draws["pos"]), 0.0, flat)
        flat = torch.where(neg & ~_keep_k(neg, neg_max, draws["neg"]), 0.0, flat)
        lab = flat.reshape(lab.shape)
    cls = torch.sum((lab != 0.0).float() * F.softplus(-lab * logits))
    d = (reg - reg_map).abs()
    sl1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    return cls + torch.sum((lab > 0.0).float().repeat(1, 1, 1, 4) * sl1)


def group_factor(name: str) -> float:
    return 0.1 if name.startswith("score_res3.") else 1.0


def trainable(name: str) -> bool:
    return not (name.endswith("running_mean") or name.endswith("running_var")
                or name.startswith("score4_upsample."))


def normalise(u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=u8.device)
    std = torch.tensor(STD, device=u8.device)
    return ((u8.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


def run_steps(weights: dict, batches: list, seed: int, cfg: dict, templates: np.ndarray, device,
              stages, fault: Optional[str] = None, channels_last: bool = False,
              change_at: Optional[int] = None) -> dict:
    """The reference's first len(batches) steps from `weights` (copied).
    Returns the losses, per trainable leaf the first step's gradient norm
    (`grad`) and the norm of gradient plus decay as the optimizer gets it
    (`update`, its momentum after one step), the norm of each leaf's
    change after `change_at` steps (`change`; default all of them), and
    that of the last step's own change (`window`).

    `fault` plants one of the faults the comparison must catch: "half"
    (the step on the first half of the rows, the loss scaled to the whole
    batch), "leaf" (the largest leaf's first gradient doubled).
    `channels_last` runs the same arithmetic in another memory layout
    (other convolution kernels, another order of summation)."""
    w = {k: v.detach().clone().to(device) for k, v in weights.items()}
    if channels_last:
        w = {k: v.contiguous(memory_format=torch.channels_last) if v.dim() == 4 else v for k, v in w.items()}
    names = [n for n in w if trainable(n)]
    for n in names:
        w[n].requires_grad_(True)
    start = {n: w[n].detach().clone() for n in names}
    model = Detector(w, stages)
    tmpl = torch.tensor(templates, dtype=torch.float32, device=device)
    vsy, vsx = cfg["heatmap_size"]
    anchors = vsy * vsx * cfg["num_templates"]
    mom: dict = {}
    change_at = len(batches) if change_at is None else change_at
    out = {"losses": [], "grad": {}, "update": {}, "change": {}, "window": {}, "change_at": change_at}
    for step, batch in enumerate(batches):
        if step == len(batches) - 1:
            before = {n: w[n].detach().clone() for n in names}
        rows = batch["gt_boxes"].shape[0]
        dr = step_draws(seed, step, rows, anchors, device)
        keep = slice(0, rows // 2) if fault == "half" else slice(0, rows)
        sub = {k: v[keep] for k, v in batch.items()}
        cls_map, reg_map = targets(sub, tmpl, cfg, dr["seeds"][keep])
        x = normalise(sub["image"].to(device))
        if channels_last:
            x = x.contiguous(memory_format=torch.channels_last)
        o = model.forward(x, train=True).permute(0, 2, 3, 1)
        lv = loss(o, cls_map, reg_map, {"pos": dr["pos"][keep], "neg": dr["neg"][keep]}, cfg)
        if fault == "half":
            lv = lv * (rows / (rows // 2))
        grads = torch.autograd.grad(lv, [w[n] for n in names])
        out["losses"].append(float(lv.detach()))
        if step == 0 and fault == "leaf":
            big = max(range(len(names)), key=lambda i: float(grads[i].norm()))
            grads = tuple(g * 2.0 if i == big else g for i, g in enumerate(grads))
        with torch.no_grad():
            for n, g in zip(names, grads):
                d = g + cfg["weight_decay"] * w[n]
                if step == 0:
                    out["grad"][n] = float(g.norm())
                    out["update"][n] = float(d.norm())
                    mom[n] = d.clone()
                else:
                    mom[n].mul_(cfg["momentum"]).add_(d)
                w[n].sub_(cfg["lr"] * group_factor(n) * mom[n])
            if step + 1 == change_at:
                out["change"] = {n: float((w[n] - start[n]).norm()) for n in names}
    with torch.no_grad():
        out["window"] = {n: float((w[n] - before[n]).norm()) for n in names}
    return out


def numbers(prog: dict, ref: dict) -> dict:
    """Each leaf's gap: |program's norm - reference's| over the larger of the
    reference leaf's norm and the median leaf's.

    loss_gap: the largest relative gap of a step's loss. update_gap: the
    largest leaf gap of the first update (gradient plus decay, the
    momentum after one step). change_gap: the median leaf gap of the change
    after `change_at` steps, over the leaves whose reference gradient is at
    least a thousandth of the median leaf's (a smaller one moves by rounding
    alone); its largest leaf gap, `change_gap_worst`, is the noise of the
    later steps (a float32 reference in another memory layout reads the
    same) and is reported, not compared. window_gap: the same median of
    the last step's own change (the timed window's first step). The loss
    gap of steps past `change_at` (`window_loss_gap`) is that noise too and
    is reported, not compared."""
    n = ref["change_at"]
    gaps_all = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    loss_gap = max(gaps_all[:n])

    def gaps(key, leaves):
        med = float(np.median([ref[key][n] for n in leaves]))
        return [abs(prog[key][n] - ref[key][n]) / max(ref[key][n], med) for n in leaves]

    leaves = sorted(ref["update"])
    gmed = float(np.median([ref["grad"][n] for n in leaves]))
    moved = [n for n in leaves if ref["grad"][n] >= 1e-3 * gmed]
    change = gaps("change", moved)
    return {"loss_gap": loss_gap, "update_gap": max(gaps("update", leaves)),
            "change_gap": float(np.median(change)), "change_gap_worst": max(change),
            "window_gap": float(np.median(gaps("window", moved))),
            "window_loss_gap": max(gaps_all[n:], default=0.0), "loss_gaps": gaps_all,
            "losses": list(ref["losses"])}

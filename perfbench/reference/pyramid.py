"""The reference's evaluation of one image (reference `evaluate_model.py`,
`evaluation.py`), in float32 on any device.

1. The image is the JPEG's decode (the caller's: traffic/jpeg.decode for
   files whose coefficients the harness made, in float with no rounding).
   The canvas is the image's size bucket (`bucket`), the image at its top
   left and the ImageNet mean pixel (123, 116, 103) everywhere else.
2. Each level 2**s resizes the whole normalised canvas onto a canvas of
   the level (each side rounded to 32) by the image's own factors, the
   short side going to int(short * 2**s) and the long side to
   int(short' * long / short): an antialiased triangle filter on
   half-pixel centres, normalised over the taps inside the canvas
   (`resize_weights`, jax.image.scale_and_translate's "linear"). Level 1
   is the canvas itself.
3. Each level's logits: sigmoid over the templates that may fire there
   (`template_ids`), rows and columns past the level's own size zeroed, the
   1000 most probable cells (ties to the lowest flat (y, x, t) index)
   kept if above prob_thresh, each decoded from its anchor and
   regression and divided by the scale.
4. Greedy NMS over all levels (stable descending order of the logit; a
   row is dropped if its IoU with a kept row exceeds nms_thresh), at most
   750 kept.

`detect` also returns each level's whole output, for the comparison to
find the reference's own cell of any detection the port returns.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
MEAN_PIXEL = (123, 116, 103)


def bucket(x: int) -> int:
    """The canvas side of an image side: multiples of 64 up to 512 px,
    then coarser, so the shapes stay few and padding under ~25%."""
    m = max(64, min(512, 1 << max(max(x - 1, 1).bit_length() - 3, 0)))
    return -(-x // m) * m


def canvas(image: np.ndarray) -> np.ndarray:
    h, w = image.shape[:2]
    out = np.empty((bucket(h), bucket(w), 3), np.float64)
    out[:] = MEAN_PIXEL
    out[:h, :w] = image
    return out


def level_size(h: int, w: int, s: int) -> tuple[int, int]:
    short = min(h, w)
    ts = short << s if s >= 0 else short >> (-s)
    return (ts, w * ts // h) if h <= w else (h * ts // w, ts)


def level_canvas(hp: int, wp: int, s: int) -> tuple[int, int]:
    f = 2.0 ** s
    return (-(-int(round(hp * f)) // 32) * 32, -(-int(round(wp * f)) // 32) * 32)


def resize_weights(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) float64 weights of the antialiased linear resize."""
    inv = 1.0 / scale
    ks = max(inv, 1.0)
    pos = (np.arange(n_out)[:, None] + 0.5) * inv - 0.5
    x = np.abs(pos - np.arange(n_in)[None, :]) / ks
    wts = np.maximum(1.0 - x, 0.0)
    tot = wts.sum(1, keepdims=True)
    wts = np.where(tot > 1000 * np.finfo(np.float32).eps, wts / np.where(tot != 0, tot, 1), 0.0)
    return np.where((pos >= -0.5) & (pos <= n_in - 0.5), wts, 0.0)


def template_ids(templates: np.ndarray, scale: float) -> np.ndarray:
    """The reference's per-scale pruning (models/utils.py): ids 4..11 fire
    at every scale; of ids 18..24 (natural scale column 4) those >= 1 are
    pruned below scale 1, and at scale >= 1 those != 1 (both branches of
    the reference compare with 1.0)."""
    ids = set(range(4, 12))
    one = [i for i in range(18, min(25, len(templates)))]
    ts = templates[:, 4]
    keep = [i for i in one if (ts[i] < 1.0 if scale < 1 else ts[i] == 1.0)]
    return np.array(sorted(ids.union(keep)), np.int64)


def normalised(image: np.ndarray, device) -> torch.Tensor:
    """(1, 3, H, W) float32 normalised pixels of an (H, W, 3) image in
    [0, 255] (any dtype)."""
    x = torch.from_numpy(np.asarray(image, np.float64)).to(device).permute(2, 0, 1)[None].float() / 255.0
    mean = torch.tensor(MEAN, device=device)[None, :, None, None]
    std = torch.tensor(STD, device=device)[None, :, None, None]
    return (x - mean) / std


def _decode(out, ids, templates_t, flat, f, stride, offset, nt):
    """Boxes (n, 4) and logits (n,) of the flat (y, x, t_local) indices."""
    hh, ww, _ = out.shape
    ntv = len(ids)
    t = ids[flat % ntv]
    x = (flat // ntv) % ww
    y = flat // (ntv * ww)
    cx = x.float() * stride + offset
    cy = y.float() * stride + offset
    cw = templates_t[t, 2] - templates_t[t, 0] + 1.0
    ch = templates_t[t, 3] - templates_t[t, 1] + 1.0
    v = out[y, x]  # (n, 5T)
    logit, tx, ty, tw, th = (v.gather(1, (t + k * nt)[:, None])[:, 0] for k in range(5))
    rcx, rcy = cx + cw * tx, cy + ch * ty
    rcw, rch = cw * torch.exp(tw), ch * torch.exp(th)
    boxes = torch.stack([rcx - rcw / 2, rcy - rch / 2, rcx + rcw / 2, rcy + rch / 2], 1) / f
    return boxes, logit


def iou_matrix(a, b, device=None) -> torch.Tensor:
    """(N, M) float64 IoU of continuous-coordinate boxes (arrays or
    tensors), on `device` (the inputs' by default)."""
    a = torch.as_tensor(a, dtype=torch.float64, device=device)[:, :4]
    b = torch.as_tensor(b, dtype=torch.float64, device=device or a.device)[:, :4]
    iw = (torch.minimum(a[:, None, 2], b[None, :, 2]) - torch.maximum(a[:, None, 0], b[None, :, 0])).clamp_min(0)
    ih = (torch.minimum(a[:, None, 3], b[None, :, 3]) - torch.maximum(a[:, None, 1], b[None, :, 1])).clamp_min(0)
    inter = iw * ih
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0), 0.0)


def nms(boxes: torch.Tensor, scores: torch.Tensor, thresh: float) -> torch.Tensor:
    """Indices kept by greedy NMS, in descending (stable) score order."""
    order = torch.sort(scores, descending=True, stable=True).indices
    over = (iou_matrix(boxes[order], boxes[order]) > thresh).cpu().numpy()
    dead = np.zeros(len(order), bool)
    keep = []
    for i in range(len(order)):
        if not dead[i]:
            keep.append(i)
            dead |= over[i]
    return order[torch.tensor(keep, dtype=torch.int64, device=order.device)]


@torch.no_grad()
def detect(model, image: np.ndarray, templates: np.ndarray, ev: dict, rf: dict, device) -> dict:
    """The reference's detections of one decoded (H, W, 3) image (see the module
    docstring), on `device`: final (N, 5) float64 [x1, y1, x2, y2, logit],
    final_level (N,), cuts: the per-level logit of the 1000th kept cell
    (-inf where fewer were above the threshold), final_cut: the logit of
    the last kept row where max_total_dets cut the list (-inf otherwise),
    and levels: per level every cell's decoded box and logit (the rows and
    columns of the level's own size, the templates that may fire)."""
    h, w = image.shape[:2]
    cv = canvas(image)
    hp, wp = cv.shape[:2]
    x0 = normalised(cv, device)
    nt = len(templates)
    templates_t = torch.tensor(templates, dtype=torch.float32, device=device)
    thr = float(ev["prob_thresh"])
    thr_logit = math.log(thr / (1 - thr))
    fin_b, fin_s, fin_l, cuts, maps = [], [], [], [], []
    for li, s in enumerate(ev["scales"]):
        f = 2.0 ** s
        th, tw = level_size(h, w, s)
        thp, twp = level_canvas(hp, wp, s)
        th, tw = min(max(th, 1), thp), min(max(tw, 1), twp)
        if (thp, twp) == (hp, wp) and f == 1.0:
            xs = x0
        else:
            wh = torch.tensor(resize_weights(hp, thp, th / h), dtype=torch.float32, device=device)
            ww = torch.tensor(resize_weights(wp, twp, tw / w), dtype=torch.float32, device=device)
            xs = torch.matmul(torch.matmul(wh, x0), ww.t())
        out = model.forward(xs)[0].permute(1, 2, 0)  # (hh, ww, 5T)
        ids_np = template_ids(templates, f)
        ids = torch.tensor(ids_np, device=device)
        hv, wv = -(-th // rf["stride"]), -(-tw // rf["stride"])
        logit = out[:, :, ids].clone()
        logit[hv:] = -math.inf
        logit[:, wv:] = -math.inf
        flat_logit = logit.reshape(-1)
        prob = torch.sigmoid(flat_logit)
        order = torch.sort(prob, descending=True, stable=True).indices[: ev["max_dets_per_scale"]]
        top = order[prob[order] > thr]
        if len(top):
            b, lg = _decode(out, ids, templates_t, top, f, rf["stride"], rf["offset"], nt)
            fin_b.append(b)
            fin_s.append(lg)
            fin_l.append(torch.full((len(top),), li, device=device))
        full = len(order) == ev["max_dets_per_scale"] and bool(prob[order[-1]] > thr)
        cuts.append(float(flat_logit[order[-1]]) if full else -math.inf)
        every = torch.arange(hv * wv * len(ids), device=device)
        every = (every // (wv * len(ids))) * (out.shape[1] * len(ids)) + every % (wv * len(ids))
        b, lg = _decode(out, ids, templates_t, every, f, rf["stride"], rf["offset"], nt)
        maps.append({"boxes": b, "logits": lg})
    if fin_b:
        boxes, scores, levels = torch.cat(fin_b).double(), torch.cat(fin_s).double(), torch.cat(fin_l)
        keep = nms(boxes, scores, ev["nms_thresh"])
        final_cut = float(scores[keep[ev["max_total_dets"] - 1]]) if len(keep) > ev["max_total_dets"] else -math.inf
        keep = keep[: ev["max_total_dets"]]
        final = torch.cat([boxes[keep], scores[keep, None]], 1)
        final_level = levels[keep]
    else:
        final_cut = -math.inf
        final = torch.zeros((0, 5), dtype=torch.float64, device=device)
        final_level = torch.zeros((0,), dtype=torch.int64, device=device)
    return {"final": final, "final_level": final_level, "cuts": cuts, "final_cut": final_cut,
            "levels": maps, "thr_logit": thr_logit}

"""Set-up the pyramid cells share: the JPEG pool, the seeded and calibrated
weights, the port's PyramidDetector over them, and the reference check of
the detections the timed path returned."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import weights as W
from perfbench.reference import compare, pyramid
from perfbench.reference.model import Detector
from perfbench.traffic import generate, jpeg


def rng(seed: int, key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2**63, key]))


def eval_setup(run) -> dict:
    """The pool, the weights and the port's detector of an eval cell."""
    c, t = run.config, run.traffic
    ev = c["eval"]
    stages = tuple(c["stage_sizes"])
    templates = np.asarray(c["templates"], np.float64)
    t0 = time.perf_counter()
    made = generate.jpeg_pool(rng(run.seed, 1), t["pool"], t["height"], t["width"], t["quality"])
    pool, coefs = [m[0] for m in made], [m[1] for m in made]
    t1 = time.perf_counter()
    weights = W.make(run.seed, run.device, stages, len(templates))
    env = {"pool": pool, "coefs": coefs, "weights": weights, "templates": templates, "stages": stages}
    calib = [pixels(env, i) for i in range(t["calib_images"])]
    fired = W.calibrate(weights, calib, run.device, stages, templates=len(templates),
                        prob_thresh=ev["prob_thresh"], fraction=t["fire_fraction"])
    t2 = time.perf_counter()
    from tinyfaces_tpu_torch.config import DetectorConfig, EvalConfig
    from tinyfaces_tpu_torch.evaluation import PyramidDetector
    from tinyfaces_tpu_torch.models.detection import TinyFacesDetector

    dtype = getattr(torch, c["dtype"])
    model = TinyFacesDetector(num_templates=len(templates), stage_sizes=stages, dtype=dtype)
    model.load_state_dict({k: v.detach().clone() for k, v in weights.items()})
    ec = EvalConfig(prob_thresh=ev["prob_thresh"], nms_thresh=ev["nms_thresh"],
                    scales=tuple(ev["scales"]), max_dets_per_scale=ev["max_dets_per_scale"],
                    max_total_dets=ev["max_total_dets"], fold_stem=ev["fold_stem"],
                    resample=ev["resample"], template_pruning=ev["template_pruning"])
    det = PyramidDetector(model.to(run.device).eval(), templates, DetectorConfig(), ec,
                          device=run.device, transfer=c["wire"])
    run.log(f"set-up: pool {len(pool)} JPEGs {t1 - t0:.2f} s, weights and calibration "
            f"{t2 - t1:.2f} s (cells that clear the threshold per image by level: {fired})")
    env["det"] = det
    if c["wire"] == "rgb":  # the pixel wire, fed what the reference reads, in uint8
        env["pool"] = env["inputs"] = [np.clip(np.round(pixels(env, i)), 0, 255).astype(np.uint8)
                                       for i in range(len(pool))]
    return env


def pixels(env: dict, idx: int) -> np.ndarray:
    """What pool file idx holds, as the reference reads it: (H, W, 3)
    float64 RGB, the exact decode of its coefficients (traffic/jpeg.py)."""
    return jpeg.decode(env["coefs"][idx])


def graphs(det) -> int:
    return sum(s["graphs"] for s in det.graph_stats())


def release(env: dict) -> None:
    """Free the port's state before the reference runs."""
    env.pop("det", None)
    env.pop("service", None)
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


@torch.no_grad()
def reference_numbers(run, env: dict, items: list, *, quant=None, explain: bool = False) -> dict:
    """The comparison's numbers over `items`, each (pool index, the port's
    (N, 5) detections), against the float32 reference (TF32 off), or, with
    `quant` (reference/model.fp8_e4m3 for the bf16 cells), that reference
    put in the port's place."""
    c = run.config
    ev = c["eval"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ref_model = Detector(env["weights"], env["stages"])
        low = Detector(env["weights"], env["stages"], quant=quant) if quant else None
        per = []
        for idx, dets in items:
            image = env["inputs"][idx] if "inputs" in env else pixels(env, idx)
            ref = pyramid.detect(ref_model, image, env["templates"], ev, c["rf"], run.device)
            if low is not None:
                dets = pyramid.detect(low, image, env["templates"], ev, c["rf"], run.device)["final"]
            per.append(compare.numbers(dets, ref, ev["nms_thresh"]))
            if explain:
                per[-1]["why"] = compare.explain_miss(dets, ref, ev["nms_thresh"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    out = compare.worst(per)
    if explain:
        out["why"] = max(per, key=lambda p: p["miss"])["why"]
    return out


def add_checks(run, nums: dict) -> None:
    lim = run.config["limits"]
    for k in ("score_gap", "miss", "overlap"):
        run.checks.append((k, nums[k], lim[k]))


def sample(run, done: list, n: int) -> list:
    """n of the (pool index, detections) the window returned, drawn from
    the seed, with the one holding the most detections among them."""
    if not done:
        return []
    pick = rng(run.seed, 7).choice(len(done), size=min(n, len(done)), replace=False).tolist()
    most = max(range(len(done)), key=lambda i: len(done[i][1]))
    if most not in pick:
        pick[-1] = most
    return [done[i] for i in pick]



"""Offline template generation: k-medoids over GT box shapes.

The port's copy of tinyfaces_tpu/clustering/cluster.py, host NumPy as
there, so the medoids are equal to the JAX package's: the same arithmetic
and the same draws from `np.random.default_rng(seed)`, call for call.
Reference flow (tinyfaces/clustering/cluster.py:14-130,
k_medoids.py:6-69): center all train GT boxes to (-w/2, -h/2, w/2, h/2),
build a 1-IoU distance matrix, run k-medoids for k=25, and emit the medoid
boxes as the canonical templates.

As in the JAX package:
  * the pairwise-IoU matrix is one vectorized NumPy broadcast;
  * two backends replace the reference's third-party dependencies: "local"
    is Voronoi-iteration k-medoids (the reference's 'local' option) and
    "pam" is a vectorized BUILD+SWAP PAM — the algorithm pyclustering's C++
    core implements — reached also via the reference's option names
    'pyclustering'/'pyclust';
  * the distance-matrix cache is a plain .npy file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


def centralize_bbox(bboxes: np.ndarray) -> np.ndarray:
    """(N, 4) corner boxes -> origin-centered boxes (cluster.py:14-25).

    Uses the +1 size convention: a box spanning [x1, x2] has w = x2-x1+1 and
    centers to (-(w-1)/2, ..., (w-1)/2).
    """
    hs = bboxes[:, 3] - bboxes[:, 1] + 1
    ws = bboxes[:, 2] - bboxes[:, 0] + 1
    return np.stack(
        [-(ws - 1) / 2, -(hs - 1) / 2, (ws - 1) / 2, (hs - 1) / 2], axis=1
    )


def compute_distances(bboxes: np.ndarray) -> np.ndarray:
    """(N, N) pairwise 1-IoU distance matrix: 1 - metrics.jaccard_index of
    every pair, broadcast (continuous convention, unclamped intersection;
    centered boxes all contain the origin, so every pair overlaps)."""
    x1 = np.maximum(bboxes[:, None, 0], bboxes[None, :, 0])
    y1 = np.maximum(bboxes[:, None, 1], bboxes[None, :, 1])
    x2 = np.minimum(bboxes[:, None, 2], bboxes[None, :, 2])
    y2 = np.minimum(bboxes[:, None, 3], bboxes[None, :, 3])
    inter = (x2 - x1) * (y2 - y1)
    areas = (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1])
    union = areas[:, None] + areas[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, inter / union, 0.0)
    return 1.0 - iou


def k_medoids(distances: np.ndarray, k: int, rng: np.random.Generator,
              max_iter: int = 300):
    """Voronoi-iteration k-medoids on a precomputed distance matrix.

    Returns (medoid_indices (k,), assignment (N,)).
    """
    n = distances.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} available boxes")
    medoids = rng.choice(n, size=k, replace=False)

    for _ in range(max_iter):
        assign = np.argmin(distances[medoids, :], axis=0)  # (N,)
        new_medoids = medoids.copy()
        for c in range(k):
            members = np.where(assign == c)[0]
            if members.size == 0:
                continue
            within = distances[np.ix_(members, members)]
            new_medoids[c] = members[int(np.argmin(within.sum(axis=1)))]
        if np.array_equal(np.sort(new_medoids), np.sort(medoids)):
            break
        medoids = new_medoids

    assign = np.argmin(distances[medoids, :], axis=0)
    return medoids, assign


def pam(distances: np.ndarray, k: int, rng: np.random.Generator,
        max_swaps: int = 200):
    """PAM k-medoids: greedy BUILD init + best-improvement SWAP phase.

    Deterministic: `rng` is taken for the BACKENDS interface and never
    drawn from. Returns (medoid_indices (k,), assignment (N,)).
    """
    n = distances.shape[0]
    if k > n:
        raise ValueError(f"k={k} exceeds the {n} available boxes")

    # BUILD: start from the 1-medoid optimum, then greedily add the point
    # that most reduces total nearest-medoid distance.
    medoids = [int(np.argmin(distances.sum(axis=1)))]
    d1 = distances[medoids[0]].copy()  # (N,) nearest-medoid distance
    while len(medoids) < k:
        # gain[c] = total reduction if candidate c becomes a medoid
        gain = np.maximum(d1[None, :] - distances, 0.0).sum(axis=1)
        gain[medoids] = -np.inf
        c = int(np.argmax(gain))
        medoids.append(c)
        d1 = np.minimum(d1, distances[c])

    medoids = np.asarray(medoids)

    def nearest_two(med):
        dm = distances[med]  # (k, N)
        order = np.argsort(dm, axis=0, kind="stable")
        i1 = order[0]
        d1 = dm[i1, np.arange(n)]
        d2 = dm[order[1], np.arange(n)] if len(med) > 1 else np.full(n, np.inf)
        return i1, d1, d2  # i1 indexes into `med`

    for _ in range(max_swaps):
        i1, d1, d2 = nearest_two(medoids)
        # base[h] = sum_j min(0, D[h,j] - d1[j])  (gain from points that
        # would defect to candidate h regardless of which medoid leaves)
        diff = distances - d1[None, :]  # (N_h, N_j)
        neg = np.minimum(diff, 0.0)
        base = neg.sum(axis=1)
        best = (0.0, None, None)
        for mi in range(len(medoids)):
            mask = i1 == mi  # points whose nearest medoid is medoids[mi]
            if not mask.any():
                delta = base.copy()
            else:
                # for those points the leaving medoid forces a move:
                # cost becomes min(d2[j], D[h,j]) instead of d1[j]
                forced = (
                    np.minimum(distances[:, mask], d2[None, mask])
                    - d1[None, mask]
                ).sum(axis=1)
                delta = base - neg[:, mask].sum(axis=1) + forced
            delta[medoids] = np.inf
            h = int(np.argmin(delta))
            if delta[h] < best[0] - 1e-12:
                best = (float(delta[h]), mi, h)
        if best[1] is None:
            break
        medoids = medoids.copy()
        medoids[best[1]] = best[2]

    assign = np.argmin(distances[medoids, :], axis=0)
    return medoids, assign


BACKENDS = {
    "local": k_medoids,
    "pam": pam,
    # reference option names (cluster.py:65,94) map onto the PAM backend
    "pyclustering": pam,
    "pyclust": pam,
}


def compute_kmedoids(
    bboxes: np.ndarray,
    cls: int,
    option: str = "local",
    indices: int = 15,
    max_clusters: int = 35,
    max_limit: int = 5000,
    cache_dir: Optional[str | Path] = None,
    seed: int = 0,
):
    """Cluster GT box shapes for k in [indices, max_clusters].

    Returns a list where entry k (appended in order) is
    {"n_clusters": k, "medoids": (k, 4) array, "class": cls}, preceded by
    `indices` empty placeholder dicts — the reference's exact return layout
    (cluster.py:46, :86-91), so callers index `clustering[num_templates]`.
    """
    rng = np.random.default_rng(seed)
    clustering: list[dict] = [{} for _ in range(indices)]

    boxes = centralize_bbox(np.asarray(bboxes, np.float64))

    if boxes.shape[0] > max_limit:
        sub = rng.choice(boxes.shape[0], size=max_limit, replace=False)
        boxes = boxes[sub]

    cache = Path(cache_dir) / f"distances_{cls}.npy" if cache_dir else None
    if cache is not None and cache.exists():
        dist = np.load(cache)
    else:
        dist = compute_distances(boxes)
        if cache is not None:
            np.save(cache, dist)

    try:
        backend = BACKENDS[option]
    except KeyError:
        raise ValueError(
            f"unknown clustering backend {option!r}; choose from {sorted(BACKENDS)}"
        ) from None

    for k in range(indices, max_clusters + 1):
        medoid_idx, _ = backend(dist, k, rng)
        clustering.append(
            {"n_clusters": k, "medoids": boxes[medoid_idx], "class": cls}
        )

    return clustering

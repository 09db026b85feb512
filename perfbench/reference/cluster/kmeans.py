"""Weighted Lloyd k-means with deterministic farthest-point seeding, host
numpy — the k-means of the spectral clusterer's numpy path (the one the JAX
package ran on the TPU), step for step."""
from __future__ import annotations

import numpy as np


def farthest_point_init(x: np.ndarray, k: int) -> np.ndarray:
    """Start at the point closest to the mean, then repeatedly take the
    point farthest from all chosen seeds."""
    n = x.shape[0]
    centers = np.zeros((k, x.shape[1]))
    centers[0] = x[np.argmin(((x - x.mean(0)) ** 2).sum(1))]
    min_d = np.full(n, np.inf)
    for i in range(1, k):
        min_d = np.minimum(min_d, ((x - centers[i - 1]) ** 2).sum(1))
        centers[i] = x[np.argmax(min_d)]
    return centers


def kmeans(x: np.ndarray, k: int, iters: int = 25,
           sample_weight: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """-> (labels [N] int32, centers [k, D]).  Points of zero weight are
    assigned but do not move the centroids; an empty centroid stays put."""
    w = np.ones(x.shape[0]) if sample_weight is None else sample_weight
    centers = farthest_point_init(x, k)
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        labels = d.argmin(1)
        for j in range(k):
            sel = (labels == j) & (w > 0)
            if sel.any():
                centers[j] = x[sel].mean(0)
    d = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
    return d.argmin(1).astype(np.int32), centers

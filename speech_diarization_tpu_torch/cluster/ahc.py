"""Agglomerative clustering with a cosine-distance threshold, on the host.

The JAX package's ``cluster/ahc.py``, copied (host numpy and scipy):
average-linkage AHC over cosine distances, cut at ``1 - cos_threshold`` and
optionally clamped to a [min_speakers, max_speakers] cluster count.  N is
the number of segments (tens to hundreds), so this costs microseconds.
"""
from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import squareform


def ahc_cluster(
    embs: np.ndarray,
    cos_threshold: float = 0.70,
    min_speakers: int | None = None,
    max_speakers: int | None = None,
    affinity: np.ndarray | None = None,
) -> np.ndarray:
    """Average-linkage AHC cut at distance ``1 - cos_threshold``; optionally
    clamped to a [min_speakers, max_speakers] cluster-count range."""
    embs = np.asarray(embs, dtype=np.float64)
    n = embs.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    if n == 1:
        return np.zeros((1,), dtype=np.int32)

    if affinity is None:
        e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-9)
        affinity = e @ e.T
    dist = np.clip(1.0 - affinity, 0.0, None)
    np.fill_diagonal(dist, 0.0)
    z = linkage(squareform(dist, checks=False), method="average")

    labels = fcluster(z, t=1.0 - cos_threshold, criterion="distance") - 1
    k = labels.max() + 1
    if max_speakers is not None and k > max_speakers:
        labels = fcluster(z, t=max_speakers, criterion="maxclust") - 1
    elif min_speakers is not None and k < min_speakers and n >= min_speakers:
        labels = fcluster(z, t=min_speakers, criterion="maxclust") - 1
    # contiguous relabel by first appearance
    uniq, first = np.unique(labels, return_index=True)
    order = uniq[np.argsort(first)]
    remap = {int(u): i for i, u in enumerate(order)}
    return np.array([remap[int(l)] for l in labels], dtype=np.int32)

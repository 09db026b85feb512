"""Density-based clustering (HDBSCAN), on the host.

The JAX package's ``cluster/density.py``, copied (host numpy and scipy),
with scikit-learn's HDBSCAN replaced by the port's own numpy
implementation of the same algorithm (``cluster/hdbscan.py``: equal labels
on equal inputs), so that the port needs no scikit-learn:

* :func:`hdbscan_cluster`: single-stage HDBSCAN over cosine distances
  (noise stays -1, EOM selection by default);
* :func:`hdbscan_cleaned`: leaf-selection HDBSCAN, noise kept as singleton
  clusters, then an average-linkage merge of the unit centroids at a cosine
  threshold (``--cluster-method hdbscan``);
* :func:`hdbscan_two_stage`: the same over-cluster -> centroid -> merge
  scheme with an N-aware minimum cluster size on L2-normalized embeddings
  (``--cluster-method hdbscan2``).

Stage 1 must over-cluster (many pure micro-clusters), which needs
``cluster_selection_method='leaf'``; noise points become singleton
micro-clusters and the centroid merge decides where they go.
"""
from __future__ import annotations

import numpy as np

from .hdbscan import hdbscan_labels


def _normalize(embs: np.ndarray) -> np.ndarray:
    embs = np.asarray(embs, dtype=np.float64)
    return embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)


def hdbscan_cluster(
    embs: np.ndarray,
    min_cluster_size: int = 2,
    min_samples: int | None = None,
    precomputed_cosine: bool = True,
    allow_single_cluster: bool = True,
    cluster_selection_method: str = "eom",
) -> np.ndarray:
    """Single-stage HDBSCAN over cosine distances
    (``cluster_hdbscan``, ``anti_stick_diarize.py:175-186``)."""
    embs = np.asarray(embs, dtype=np.float64)
    n = embs.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    if n < max(2, min_cluster_size):
        return np.zeros((n,), dtype=np.int32)
    e = _normalize(embs)
    if precomputed_cosine:
        d = np.clip(1.0 - e @ e.T, 0.0, None)
        np.fill_diagonal(d, 0.0)
        return hdbscan_labels(
            d, min_cluster_size, min_samples, precomputed=True,
            allow_single_cluster=allow_single_cluster,
            cluster_selection_method=cluster_selection_method).astype(np.int32)
    return hdbscan_labels(
        e, min_cluster_size, min_samples,
        allow_single_cluster=allow_single_cluster,
        cluster_selection_method=cluster_selection_method).astype(np.int32)


def _merge_centroids_by_threshold(
    centroids: np.ndarray, cos_threshold: float
) -> np.ndarray:
    """Average-linkage agglomerative merge of unit centroids at cosine
    similarity >= ``cos_threshold``.  Robust down to 2 centroids (where
    density estimation is meaningless)."""
    m = centroids.shape[0]
    if m <= 1:
        return np.zeros(m, dtype=np.int32)
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    d = np.clip(1.0 - centroids @ centroids.T, 0.0, None)
    np.fill_diagonal(d, 0.0)
    z = linkage(squareform(d, checks=False), method="average")
    labels = fcluster(z, t=1.0 - cos_threshold, criterion="distance") - 1
    return labels.astype(np.int32)


def hdbscan_cleaned(
    embs: np.ndarray,
    min_cluster_size: int = 2,
    centroid_cos_threshold: float = 0.70,
) -> np.ndarray:
    """Single-stage density clustering with the cleanup the pipeline needs
    for DER: leaf selection (EOM on tens of points both merges and splits
    speakers), noise kept as singleton clusters, then a centroid threshold
    merge.  ``hdbscan_cluster`` above stays reference-faithful (EOM,
    noise=-1) for parity experiments."""
    embs = np.asarray(embs, dtype=np.float64)
    n = embs.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    if n <= 2:
        return np.zeros(n, dtype=np.int32)
    e = _normalize(embs)
    stage1 = hdbscan_cluster(
        e, min_cluster_size=min_cluster_size, precomputed_cosine=True,
        allow_single_cluster=False, cluster_selection_method="leaf",
    )
    n_c = int(stage1.max()) + 1
    stage1 = stage1.copy()
    noise = np.flatnonzero(stage1 < 0)
    stage1[noise] = n_c + np.arange(len(noise), dtype=np.int32)
    n_c += len(noise)
    if n_c < 1:
        stage1 = np.arange(n, dtype=np.int32)
        n_c = n
    centroids = _normalize(
        np.stack([e[stage1 == i].mean(axis=0) for i in range(n_c)])
    )
    merged = _merge_centroids_by_threshold(centroids, centroid_cos_threshold)
    return merged[stage1].astype(np.int32)


def hdbscan_two_stage(
    embs: np.ndarray,
    min_cluster_size: int = 2,
    centroid_cos_threshold: float = 0.70,
) -> np.ndarray:
    """Two-stage anti-stick clustering (``cluster_hdbscan_two_stage``,
    ``anti_stick_diarize.py:189-270``): over-cluster L2-normalized embeddings
    into micro-clusters (leaf-selection HDBSCAN), average each micro-cluster
    into a unit centroid, merge centroids at ``centroid_cos_threshold``
    cosine similarity, and propagate the merged label back to every member.

    ``min_cluster_size`` is N-aware: clamped to keep at least ~4 micro-
    clusters possible so small files (few segments) don't collapse to one.
    """
    embs = np.asarray(embs, dtype=np.float64)
    n = embs.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    if n <= 2:
        return np.zeros(n, dtype=np.int32)
    e = _normalize(embs)

    mcs = int(np.clip(min_cluster_size, 2, max(2, n // 4)))
    stage1 = hdbscan_cluster(
        e, min_cluster_size=mcs, precomputed_cosine=False,
        allow_single_cluster=False, cluster_selection_method="leaf",
    )
    n_micro = int(stage1.max()) + 1

    # Noise points become singleton micro-clusters: a speaker with fewer
    # than min_cluster_size segments can never form a micro-cluster, and
    # folding it into the nearest foreign centroid is guaranteed confusion.
    # The centroid threshold-merge below decides whether each singleton
    # joins an existing speaker or stands alone.
    stage1 = stage1.copy()
    noise = np.flatnonzero(stage1 < 0)
    stage1[noise] = n_micro + np.arange(len(noise), dtype=np.int32)
    n_micro += len(noise)
    if n_micro < 1:
        stage1 = np.arange(n, dtype=np.int32)
        n_micro = n

    centroids = np.stack([e[stage1 == i].mean(axis=0) for i in range(n_micro)])
    centroids = _normalize(centroids)
    stage2 = _merge_centroids_by_threshold(centroids, centroid_cos_threshold)
    return stage2[stage1].astype(np.int32)

"""Clustering and score normalization, host numpy apart from whitening and
AS-Norm (torch): spectral (the numpy path of the JAX package, ROADMAP F2),
AHC, HDBSCAN and two-stage HDBSCAN, and :func:`cluster_embeddings`, the
dispatcher over them (``diar_diag.py:213-229``)."""
from .affinity import asnorm_scores, cosine_affinity, l2_normalize, whiten
from .ahc import ahc_cluster
from .density import hdbscan_cleaned, hdbscan_cluster, hdbscan_two_stage
from .kmeans import farthest_point_init, kmeans
from .spectral import (
    bisect_windows, estimate_num_speakers, refine_labels_by_windows,
    spectral_cluster,
)

__all__ = [
    "ahc_cluster",
    "asnorm_scores",
    "bisect_windows",
    "cluster_embeddings",
    "cosine_affinity",
    "estimate_num_speakers",
    "farthest_point_init",
    "hdbscan_cleaned",
    "hdbscan_cluster",
    "hdbscan_two_stage",
    "kmeans",
    "l2_normalize",
    "refine_labels_by_windows",
    "spectral_cluster",
    "whiten",
]


def cluster_embeddings(embs, method: str = "spectral", **kwargs):
    """Dispatcher mirroring ``diar_diag.cluster_embeddings`` (``diar_diag.py:213-229``)
    plus the spectral default and two-stage HDBSCAN variants."""
    import numpy as np

    embs = np.asarray(embs)
    if method == "spectral":
        return np.asarray(spectral_cluster(embs, **kwargs))
    if method == "ahc":
        return ahc_cluster(embs, **kwargs)
    if method == "hdbscan":
        return hdbscan_cluster(embs, **kwargs)
    if method == "hdbscan2":
        return hdbscan_two_stage(embs, **kwargs)
    raise ValueError(f"unknown clustering method: {method}")

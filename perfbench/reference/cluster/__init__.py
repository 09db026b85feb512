"""Clustering and score normalization, host numpy apart from whitening and
AS-Norm (torch): spectral (the numpy path of the JAX package, ROADMAP F2),
the one method the benchmark's configurations run.  The port's AHC, HDBSCAN
and two-stage HDBSCAN are not copied: no configuration reaches them."""
from .affinity import asnorm_scores, cosine_affinity, l2_normalize, whiten
from .kmeans import farthest_point_init, kmeans
from .spectral import (
    bisect_windows, estimate_num_speakers, refine_labels_by_windows,
    spectral_cluster,
)

__all__ = [
    "asnorm_scores",
    "bisect_windows",
    "cosine_affinity",
    "estimate_num_speakers",
    "farthest_point_init",
    "kmeans",
    "l2_normalize",
    "refine_labels_by_windows",
    "spectral_cluster",
    "whiten",
]

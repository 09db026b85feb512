from .affinity import asnorm_scores, l2_normalize, whiten
from .ahc import ahc_cluster
from .density import hdbscan_cleaned, hdbscan_cluster, hdbscan_two_stage
from .kmeans import farthest_point_init, kmeans
from .spectral import bisect_windows, refine_labels_by_windows, spectral_cluster

__all__ = [
    "ahc_cluster",
    "asnorm_scores",
    "bisect_windows",
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

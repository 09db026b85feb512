from .kmeans import farthest_point_init, kmeans
from .spectral import bisect_windows, refine_labels_by_windows, spectral_cluster

__all__ = [
    "bisect_windows",
    "farthest_point_init",
    "kmeans",
    "refine_labels_by_windows",
    "spectral_cluster",
]

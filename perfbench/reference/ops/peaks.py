"""Peak picking for speaker-change detection, host numpy: strict local
maxima of a z-scored distance curve (endpoints are never peaks)."""
from __future__ import annotations

import numpy as np


def local_peak_mask(x: np.ndarray) -> np.ndarray:
    """[T] -> [T] bool: strict local maxima."""
    x = np.asarray(x)
    if x.shape[-1] < 3:
        return np.zeros(x.shape, bool)
    left = np.concatenate([[np.inf], x[:-1]])
    right = np.concatenate([x[1:], [np.inf]])
    return (x > left) & (x > right)


def find_peaks_zscore(dists: np.ndarray, z_threshold: float):
    """Z-score a distance curve -> (peak_mask, z).  A (near-)constant curve
    is used unscaled."""
    d = np.asarray(dists)
    mu, sd = d.mean(), d.std()
    z = (d - mu) / max(sd, 1e-6) if sd > 1e-6 else d
    return local_peak_mask(z) & (z >= z_threshold), z

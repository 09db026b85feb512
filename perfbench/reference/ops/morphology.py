"""1-D binary morphology, host numpy, with ``scipy.ndimage`` semantics (as
the JAX package's reduce-window version): a size-k structure is centered at
index ``k//2``, and the border is False for both erosion and dilation."""
from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def _pads(k: int) -> tuple[int, int]:
    left = k // 2
    return left, k - 1 - left


def binary_erosion(mask: np.ndarray, k: int) -> np.ndarray:
    if k <= 1:
        return mask
    left, right = _pads(k)
    x = np.pad(np.asarray(mask, bool), (left, right), constant_values=False)
    return sliding_window_view(x, k).all(axis=-1)


def binary_dilation(mask: np.ndarray, k: int) -> np.ndarray:
    if k <= 1:
        return mask
    right, left = _pads(k)    # the mirrored structure: origin flips for even k
    x = np.pad(np.asarray(mask, bool), (left, right), constant_values=False)
    return sliding_window_view(x, k).any(axis=-1)


def binary_opening(mask: np.ndarray, k: int) -> np.ndarray:
    return binary_dilation(binary_erosion(mask, k), k)


def binary_closing(mask: np.ndarray, k: int) -> np.ndarray:
    return binary_erosion(binary_dilation(mask, k), k)


def morph_open_close(mask: np.ndarray, hop_ms: float, open_ms: float = 80.0,
                     close_ms: float = 40.0) -> np.ndarray:
    """Opening (despeckle) then closing (bridge) with ms-sized structures."""
    out = np.asarray(mask, bool)
    if open_ms > 0:
        out = binary_opening(out, max(1, round(open_ms / hop_ms)))
    if close_ms > 0:
        out = binary_closing(out, max(1, round(close_ms / hop_ms)))
    return out

"""Sample-rate conversion, the JAX package's ``dsp/resample.py``:

* :func:`resample_host`: scipy's polyphase ``resample_poly`` on the host in
  float64 (the I/O path and the demix front-end's 16 <-> 44.1 kHz legs);
* :func:`resample_poly`: the same Kaiser-windowed filter and phase as a
  strided ``conv1d`` over the zero-stuffed signal, on the tensor's device.
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=32)
def _poly_filter(up: int, down: int) -> np.ndarray:
    """The Kaiser-windowed lowpass of ``scipy.signal.resample_poly``'s
    defaults (``2 * 10 * max(up, down) + 1`` taps, beta 5), gain ``up``."""
    from scipy import signal as sps

    max_rate = max(up, down)
    h = sps.firwin(2 * 10 * max_rate + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float64)


def resample_host(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Host polyphase resampling along the last axis (scipy), float32 out."""
    if orig_sr == target_sr:
        return np.asarray(y, dtype=np.float32)
    from scipy import signal as sps

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    out = sps.resample_poly(np.asarray(y, dtype=np.float64), up, down, axis=-1)
    return out.astype(np.float32)


def resample_poly(y: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Polyphase resampling of a [T] or [B, T] float32 tensor on its device,
    ``ceil(T * up / down)`` samples out: the signal zero-stuffed by ``up``,
    padded so that the filter's centre tap sits on the first sample, and
    correlated with the reversed filter at stride ``down``.  Matches
    :func:`resample_host` (same filter, same phase) to float32 rounding."""
    if orig_sr == target_sr:
        return y
    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    h = torch.from_numpy(_poly_filter(up, down)[::-1].astype(np.float32)).to(y.device)
    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    b, t = y.shape
    n_out = -(-t * up // down)
    stuffed = y.new_zeros((b, (t - 1) * up + 1))
    stuffed[:, ::up] = y
    lo = (h.numel() - 1) // 2
    hi = max(0, (n_out - 1) * down + h.numel() - lo - stuffed.shape[1])
    out = F.conv1d(F.pad(stuffed, (lo, hi))[:, None], h[None, None],
                   stride=down)[:, 0, :n_out]
    return out[0] if squeeze else out

"""Hysteresis (Schmitt-trigger) binarization of VAD probabilities, host numpy.

State machine: turn on at ``p >= on``, off at ``p < off``:
``talking[t] = a[t] | (c[t] & talking[t-1])`` with ``a = p >= on`` and
``c = p >= off``, starting not talking.  Vectorized: a frame with ``a`` sets
the state, a frame with neither ``a`` nor ``c`` clears it, any other frame
copies its predecessor — so the state is on exactly where the latest setter
comes after the latest clearer.
"""
from __future__ import annotations

import numpy as np


def hysteresis_binarize(probs, on: float = 0.6, off: float = 0.4) -> np.ndarray:
    """[T] probabilities -> [T] bool speech mask (initial state: off)."""
    p = np.asarray(probs, np.float32)
    a = p >= on
    c = p >= off
    idx = np.arange(p.shape[0])
    last_set = np.maximum.accumulate(np.where(a, idx, -1))
    last_clear = np.maximum.accumulate(np.where(~a & ~c, idx, -1))
    return last_set > last_clear

"""Sticky-HMM Viterbi decoding on the host.

A K-state HMM with self-loop probability ``alpha`` and uniform switching
mass, decoded over per-step speaker scores.  K is at most the speaker cap
(8) and T the number of grid windows (about 6,000 for ten minutes), so the
decode is a float32 numpy loop over T with every step vectorized over the
K x K candidates; ties resolve to the first index, as ``argmax`` does in
the JAX package's scan.
"""
from __future__ import annotations

import numpy as np


def sticky_transition_logits(k: int, alpha: float = 0.995) -> np.ndarray:
    """float32 log transition matrix: ``alpha`` on the diagonal,
    ``(1 - alpha) / (K - 1)`` off it."""
    eps = 1e-8
    if k == 1:
        return np.zeros((1, 1), np.float32)
    off = np.log(np.float32((1.0 - alpha) / (k - 1) + eps))
    diag = np.log(np.float32(alpha + eps))
    log_a = np.full((k, k), off, np.float32)
    log_a[np.arange(k), np.arange(k)] = diag
    return log_a


def viterbi_decode(scores: np.ndarray, log_a: np.ndarray) -> np.ndarray:
    """MAP state path [T] (int32) from emission scores [T, K] and log
    transitions [K, K], with a uniform initial distribution."""
    scores = np.asarray(scores, np.float32)
    log_a = np.asarray(log_a, np.float32)
    t, k = scores.shape
    if t == 0:
        return np.zeros((0,), np.int32)
    ptrs = np.empty((t - 1, k), np.int64)
    dp = scores[0]
    cols = np.arange(k)
    for i in range(1, t):
        cand = dp[:, None] + log_a                # [K_prev, K]
        ptr = np.argmax(cand, axis=0)
        ptrs[i - 1] = ptr
        dp = cand[ptr, cols] + scores[i]
    path = np.empty(t, np.int32)
    path[-1] = state = int(np.argmax(dp))
    for i in range(t - 2, -1, -1):
        path[i] = state = int(ptrs[i, state])
    return path

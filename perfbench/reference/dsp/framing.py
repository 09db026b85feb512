"""Windowed framing of waveforms into dense [n_frames, win] grids.

The tail is zero-padded so every sample is covered (``pad_tail=True``), as in
the JAX package.  Frames are views built with ``Tensor.unfold``: no copies
until a consumer needs one.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def num_frames(n_samples: int, win: int, hop: int, pad_tail: bool = True) -> int:
    """Number of frames produced by :func:`frame_signal` (python ints only)."""
    if n_samples <= 0:
        return 0
    if n_samples < win:
        return 1 if pad_tail else 0
    n_full = 1 + (n_samples - win) // hop
    if pad_tail and (n_samples - win) % hop != 0:
        return n_full + 1
    return n_full


def frame_signal(y: torch.Tensor, win: int, hop: int,
                 pad_tail: bool = True) -> torch.Tensor:
    """Slice a waveform [..., T] into overlapping frames [..., n, win]."""
    if y.ndim not in (1, 2):
        raise ValueError(f"expected 1D or 2D waveform, got shape {tuple(y.shape)}")
    t = y.shape[-1]
    n = num_frames(t, win, hop, pad_tail)
    if n == 0:
        return y.new_zeros(y.shape[:-1] + (0, win))
    needed = (n - 1) * hop + win
    if needed > t:
        y = F.pad(y, (0, needed - t))
    return y[..., :needed].unfold(-1, win, hop)


def frame_index_grid(n_samples: int, win: int, hop: int,
                     pad_tail: bool = True) -> np.ndarray:
    """Start sample of each frame of :func:`frame_signal` (host, for
    timestamp math)."""
    return hop * np.arange(num_frames(n_samples, win, hop, pad_tail))

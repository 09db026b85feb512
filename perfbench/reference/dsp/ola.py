"""Overlap-add: frames [..., n, win] folded back at stride ``hop``.

Every frame is zero-extended to whole hops, so the fold is ``k =
ceil(win / hop)`` shifted adds of contiguous streams, with no scatter
whether or not ``hop`` divides ``win`` (the added zeros change no sum).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Fold frames [..., n, win] into a signal [..., (n-1)*hop + win]: frame
    ``i`` is added at offset ``i*hop``, unnormalized (compose with
    :func:`ola_normalization` or a window-square division)."""
    squeeze = frames.ndim == 2
    if squeeze:
        frames = frames[None]
    b, n, win = frames.shape
    t_out = (n - 1) * hop + win
    k = -(-win // hop)
    parts = F.pad(frames, (0, k * hop - win)).reshape(b, n, k, hop)
    out = frames.new_zeros((b, (n - 1 + k) * hop))
    for j in range(k):
        # part j of frame i lands at offset (i + j) * hop
        out[:, j * hop:(j + n) * hop] += parts[:, :, j, :].reshape(b, n * hop)
    out = out[:, :t_out]
    return out[0] if squeeze else out


def ola_normalization(n: int, win: int, hop: int,
                      window: torch.Tensor | None = None) -> torch.Tensor:
    """``n`` copies of ``window`` (ones of length ``win`` when None) folded
    at stride ``hop``: the denominator of a weighted overlap-add,
    [(n-1)*hop + win], clamped to at least 1e-8."""
    w = torch.ones(win) if window is None else window
    den = overlap_add(w.expand(1, n, win), hop)[0]
    return torch.clamp(den, min=1e-8)

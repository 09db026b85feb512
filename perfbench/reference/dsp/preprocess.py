"""Waveform preprocessing on tensors: DC removal, pre-emphasis, peak
clipping, peak and RMS normalization, and the diarizer's read-audio chain
(:func:`preprocess_waveform`), as the JAX package's ``dsp/preprocess.py``."""
from __future__ import annotations

import torch


def remove_dc(y: torch.Tensor) -> torch.Tensor:
    """Subtract the mean over the trailing (time) axis."""
    return y - y.mean(dim=-1, keepdim=True)


def preemphasis(y: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """First-order high-pass ``out[t] = y[t] - coef*y[t-1]``; the first
    sample sees itself as its predecessor (extend-replicate ``y[0]``)."""
    prev = torch.cat([y[..., :1], y[..., :-1]], dim=-1)
    return y - coef * prev


def peak_clip(y: torch.Tensor, limit: float = 0.99) -> torch.Tensor:
    """Clip to +-limit."""
    return torch.clamp(y, -limit, limit)


def peak_normalize(y: torch.Tensor, peak: float = 1.0) -> torch.Tensor:
    """Divide by the absolute peak when it exceeds ``peak``."""
    m = y.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(m > peak, peak / torch.clamp(m, min=1e-12),
                        torch.ones_like(m))
    return y * scale


def rms_normalize(y: torch.Tensor, target_db: float = -25.0) -> torch.Tensor:
    """Two-stage RMS normalization: scale to the target RMS, then rescale by
    the RMS of the samples whose power is above the mean (robust to long
    silences)."""
    target = 10.0 ** (target_db / 20.0)
    rms = torch.sqrt((y * y).mean(dim=-1, keepdim=True))
    y = y * (target / (rms + 1e-8))
    power = y * y
    hot = power > power.mean(dim=-1, keepdim=True)
    n_hot = hot.sum(dim=-1, keepdim=True)
    hot_ms = (torch.where(hot, power, torch.zeros_like(power)).sum(
        dim=-1, keepdim=True) / torch.clamp(n_hot, min=1))
    scale = torch.where(n_hot > 0, target / (torch.sqrt(hot_ms) + 1e-8),
                        torch.ones_like(hot_ms))
    return y * scale


def preprocess_waveform(y: torch.Tensor, dc: bool = True,
                        preemph: float | None = 0.97,
                        clip: float | None = 0.99) -> torch.Tensor:
    """The diarizer's read-audio chain after loudness normalization: DC
    removal, pre-emphasis, peak clipping, each skipped when off."""
    if dc:
        y = remove_dc(y)
    if preemph is not None:
        y = preemphasis(y, preemph)
    if clip is not None:
        y = peak_clip(y, clip)
    return y

"""Waveform preprocessing: pre-emphasis."""
from __future__ import annotations

import torch


def preemphasis(y: torch.Tensor, coef: float = 0.97) -> torch.Tensor:
    """First-order high-pass ``out[t] = y[t] - coef*y[t-1]``; the first
    sample sees itself as its predecessor (extend-replicate ``y[0]``)."""
    prev = torch.cat([y[..., :1], y[..., :-1]], dim=-1)
    return y - coef * prev

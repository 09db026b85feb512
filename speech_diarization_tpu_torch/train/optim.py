"""The optax optimizers of the JAX recipes on ``torch.optim``.

* ``optax.adam(lr)`` -> :func:`adam`: b1 0.9, b2 0.999, eps 1e-8, eps inside
  the bias-corrected denominator, as both libraries have it.
* ``optax.adamw(lr)`` -> :func:`adamw`: weight decay 1e-4 (optax's default;
  torch's is 1e-2), decoupled, on every leaf (biases and BatchNorm
  statistics included: the JAX recipes pass no mask).
* ``optax.cosine_decay_schedule(lr, steps, alpha)`` -> :func:`cosine_decay`,
  a ``LambdaLR`` whose first update uses count 0, as optax's does; call its
  ``step()`` after each ``optimizer.step()``.
"""
from __future__ import annotations

import math
from typing import Iterable

import torch


def adam(params: Iterable[torch.Tensor], lr: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def adamw(params: Iterable[torch.Tensor], lr: float,
          weight_decay: float = 1e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def cosine_factor(count: int, steps: int, alpha: float = 0.05) -> float:
    """``optax.cosine_decay_schedule(1, steps, alpha)`` at ``count``."""
    c = min(count, steps) / steps
    return (1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c)) + alpha


def cosine_decay(optimizer: torch.optim.Optimizer, steps: int,
                 alpha: float = 0.05) -> torch.optim.lr_scheduler.LambdaLR:
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: cosine_factor(count, max(steps, 1), alpha))

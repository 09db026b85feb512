"""Cosine affinity, whitening and adaptive score normalization as torch
functions on tensors of any device: the JAX package's
``cluster/affinity.py``.

``whiten`` is the pipeline's ``EmbedConfig.whiten`` step before
clustering; ``asnorm_scores`` is the AS-Norm of the reference's diagnostic
pipeline (query -> center scores z-normed against top-k cohort statistics
from both sides).
"""
from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-8, axis: int | None = None,
                 *, dim: int | None = None) -> torch.Tensor:
    """``x`` over its norm along ``axis`` (or torch's ``dim``; the last when
    neither is given) plus ``eps``."""
    if axis is not None and dim is not None:
        raise TypeError("l2_normalize takes axis= or dim=, not both")
    d = axis if axis is not None else (dim if dim is not None else -1)
    return x / (torch.linalg.norm(x, dim=d, keepdim=True) + eps)


def cosine_affinity(embs: torch.Tensor) -> torch.Tensor:
    """[N, D] -> [N, N] cosine similarity (one product)."""
    e = l2_normalize(embs)
    return e @ e.T


def whiten(embs: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """ZCA whitening then L2 normalization: center, eigendecomposition of
    the [D, D] covariance (unbiased), principal axes scaled to unit
    variance and rotated back."""
    x = embs - embs.mean(dim=0, keepdim=True)
    n = x.shape[0]
    cov = (x.T @ x) / max(n - 1, 1)
    s, u = torch.linalg.eigh(cov)                   # ascending eigenvalues
    s = torch.clamp(s, min=0.0)
    w = (u * (1.0 / torch.sqrt(s + eps))[None, :]) @ u.T
    return l2_normalize(x @ w, eps=1e-9)


def asnorm_scores(query_embs: torch.Tensor, ref_centers: torch.Tensor,
                  cohort_embs: torch.Tensor, topk: int = 200) -> torch.Tensor:
    """Adaptive symmetric score normalization: raw query -> center cosine
    scores [Nq, K], z-normed by each query's and each center's top-``topk``
    cohort scores (population std + 1e-6), the two directions averaged."""
    q = l2_normalize(query_embs)
    r = l2_normalize(ref_centers)
    c = l2_normalize(cohort_embs)
    raw = q @ r.T
    k = min(topk, c.shape[0])
    qc = torch.topk(q @ c.T, k, dim=1).values                   # [Nq, k]
    rc = torch.topk(r @ c.T, k, dim=1).values                   # [K, k]
    q_mu = qc.mean(dim=1, keepdim=True)
    q_sd = qc.std(dim=1, unbiased=False, keepdim=True) + 1e-6
    r_mu = rc.mean(dim=1)[None, :]
    r_sd = rc.std(dim=1, unbiased=False)[None, :] + 1e-6
    return 0.5 * ((raw - q_mu) / q_sd + (raw - r_mu) / r_sd)

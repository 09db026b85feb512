"""Training objectives: AAM-softmax (speaker ID), SI-SNR (enhancement),
frame BCE (VAD).  The JAX package's ``train/objectives.py``, op for op."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def aam_softmax_loss(embeddings: torch.Tensor, weights: torch.Tensor,
                     labels: torch.Tensor, margin: float = 0.2,
                     scale: float = 30.0) -> torch.Tensor:
    """Additive angular margin softmax (ArcFace) of embeddings [B, D]
    against class prototypes [n_classes, D] for int labels [B]."""
    e = embeddings / (torch.linalg.norm(embeddings, dim=1, keepdim=True) + 1e-8)
    w = weights / (torch.linalg.norm(weights, dim=1, keepdim=True) + 1e-8)
    cos = e @ w.T                                                   # [B, C]
    theta = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    target_cos = torch.cos(theta + margin)
    onehot = F.one_hot(labels.long(), weights.shape[0]).to(cos.dtype)
    logits = scale * (onehot * target_cos + (1.0 - onehot) * cos)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(onehot * logp, dim=-1))


def si_snr_loss(est: torch.Tensor, ref: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Negative scale-invariant SNR (dB) between waveforms [B, T]."""
    est = est - est.mean(dim=-1, keepdim=True)
    ref = ref - ref.mean(dim=-1, keepdim=True)
    proj = (torch.sum(est * ref, dim=-1, keepdim=True)
            / (torch.sum(ref * ref, dim=-1, keepdim=True) + eps)) * ref
    noise = est - proj
    ratio = ((torch.sum(proj * proj, dim=-1) + eps)
             / (torch.sum(noise * noise, dim=-1) + eps))
    return -torch.mean(10.0 * torch.log10(ratio))


def bce_vad_loss(probs: torch.Tensor, targets: torch.Tensor,
                 eps: float = 1e-7) -> torch.Tensor:
    """Frame-level binary cross-entropy."""
    p = torch.clamp(probs, eps, 1.0 - eps)
    return -torch.mean(targets * torch.log(p) + (1.0 - targets) * torch.log(1.0 - p))

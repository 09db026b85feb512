"""Neural VAD: the scan-free causal dilated-conv TCN (``VadConvNet``).

Runs in float32; on the card its convolutions go through cuDNN, so TF32
must be off (``utils.device.disable_tf32``): the probabilities feed the
hysteresis thresholds, where TF32's three digits would move decisions.
The recurrent ``VadNet`` and the energy VAD are not ported.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv1d_torch


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class VadConvNet(nn.Module):
    """Causal dilated-conv TCN, log-mel [B, T, M] -> prob [B, T]."""

    def __init__(self, n_mels: int = 40, channels: int = 96,
                 dilations: tuple[int, ...] = (1, 2, 4, 8, 16, 32),
                 kernel: int = 3):
        super().__init__()
        self.n_mels = n_mels
        self.channels = channels
        self.dilations = tuple(dilations)
        self.kernel = kernel
        c, m, k = channels, n_mels, kernel
        self.stem_w = _param(c, m, 5)
        self.stem_b = _param(c)
        self.out_w = _param(1, c, 1)
        self.out_b = _param(1)
        for i in range(len(self.dilations)):
            setattr(self, f"block{i}_w1", _param(c, c, k))
            setattr(self, f"block{i}_b1", _param(c))
            setattr(self, f"block{i}_w2", _param(c, c, 1))
            setattr(self, f"block{i}_b2", _param(c))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, T, M] -> probs [B, T]; strictly causal (left pad only)."""
        x = feats.transpose(1, 2)
        x = F.silu(conv1d_torch(F.pad(x, (4, 0)), self.stem_w, self.stem_b))
        k = self.kernel
        for i, d in enumerate(self.dilations):
            h = F.pad(x, ((k - 1) * d, 0))
            h = F.silu(conv1d_torch(h, getattr(self, f"block{i}_w1"),
                                    getattr(self, f"block{i}_b1"), dilation=d))
            h = conv1d_torch(h, getattr(self, f"block{i}_w2"),
                             getattr(self, f"block{i}_b2"))
            x = F.silu(x + h)
        return torch.sigmoid(conv1d_torch(x, self.out_w, self.out_b)[:, 0, :])


class VadModel(nn.Module):
    """Waveform-level wrapper: [T] -> per-10 ms-hop speech probabilities."""

    def __init__(self, net: VadConvNet | None = None, sample_rate: int = 16000,
                 hop_ms: float = 10.0, win_ms: float = 25.0):
        super().__init__()
        self.net = net or VadConvNet()
        self.sample_rate = sample_rate
        self.hop_ms = hop_ms
        self.win_ms = win_ms

    def probs_from_feats(self, feats: torch.Tensor) -> torch.Tensor:
        """Log-mel [T_f, M] or [B, T_f, M] -> probs [T_f] or [B, T_f].  No
        per-utterance mean-norm (it would break causality); inputs are
        loudness-normalized upstream, so a fixed affine rescale suffices."""
        x = (feats.float() + 6.0) * 0.25
        return self.net(x[None])[0] if feats.ndim == 2 else self.net(x)

    def probs(self, y: torch.Tensor) -> torch.Tensor:
        """[T] or [B, T] waveform -> [..., T//hop + 1] probs (a batch is one
        log-mel launch; its rows may be a strided view)."""
        from ..dsp.mel import fused_log_mel

        feats = fused_log_mel(y, sample_rate=self.sample_rate,
                              n_mels=self.net.n_mels, win_ms=self.win_ms,
                              hop_ms=self.hop_ms)
        return self.probs_from_feats(feats)

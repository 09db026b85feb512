"""The VADs of the JAX package's ``models/vad.py``:

* :class:`VadConvNet`: the scan-free causal dilated-conv TCN (the shipped
  ``vad_conv_mc.npz``);
* :class:`VadNet`: causal convs, then a GRU over steps of ``stack`` frames
  (the shipped ``vad_synthetic.npz``), written with ``nn.GRU`` (cuDNN on
  the card; torch's gate math is the JAX ``gru_sequence``'s);
* :func:`energy_vad_probs` / :class:`EnergyVad`: the deterministic
  log-energy VAD with its sort-free noise floor, the pipeline's default when
  no VAD is given.

The neural nets run in float32; on the card their convolutions and the GRU
go through cuDNN, so TF32 must be off (``utils.device.disable_tf32``): the
probabilities feed the hysteresis thresholds, where TF32's three digits
would move decisions.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..dsp.framing import frame_signal
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

    @property
    def receptive_field(self) -> int:
        """Frames a probability sees: the dilated blocks' reach plus the
        stem's kernel of 5."""
        return 1 + (self.kernel - 1) * sum(self.dilations) + 4

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


class VadNet(nn.Module):
    """Causal conv front-end + GRU, log-mel [B, T, M] -> prob [B, T].  The
    GRU steps over ``stack`` frames at a time (inputs concatenated,
    ``stack`` logits out); ``out_w`` is [hidden, stack] as in the JAX
    params."""

    def __init__(self, n_mels: int = 40, channels: int = 96, hidden: int = 96,
                 stack: int = 8):
        super().__init__()
        self.n_mels = n_mels
        self.channels = channels
        self.hidden = hidden
        self.stack = stack
        c, h, m, s = channels, hidden, n_mels, stack
        self.conv1_w = _param(c, m, 5)
        self.conv1_b = _param(c)
        self.conv2_w = _param(c, c, 3)
        self.conv2_b = _param(c)
        self.gru = nn.GRU(c * s, h, batch_first=True)
        self.out_w = _param(h, s)
        self.out_b = _param(s)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [B, T, M] -> probs [B, T]; the convs are causal (left pad
        only), a stacked step sees up to ``stack - 1`` later frames."""
        x = feats.transpose(1, 2)
        x = F.silu(conv1d_torch(F.pad(x, (4, 0)), self.conv1_w, self.conv1_b))
        x = F.silu(conv1d_torch(F.pad(x, (4, 0)), self.conv2_w, self.conv2_b,
                                dilation=2))
        x = x.transpose(1, 2)                                    # [B, T, C]
        b, t, c = x.shape
        s = self.stack
        t_pad = -(-t // s) * s
        x = F.pad(x, (0, 0, 0, t_pad - t)).reshape(b, t_pad // s, s * c)
        y, _ = self.gru(x)                                       # [B, T/s, H]
        logits = (y @ self.out_w + self.out_b).reshape(b, t_pad)[:, :t]
        return torch.sigmoid(logits)


class VadModel(nn.Module):
    """Waveform-level wrapper: [T] -> per-10 ms-hop speech probabilities."""

    def __init__(self, net: VadConvNet | VadNet | None = None,
                 sample_rate: int = 16000,
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


def energy_vad_probs(y: torch.Tensor, sample_rate: int = 16000,
                     win_ms: float = 25.0, hop_ms: float = 10.0,
                     floor_db: float = -60.0,
                     dynamic_range_db: float = 30.0) -> torch.Tensor:
    """Deterministic log-energy VAD: [T] or [B, T] -> [..., n_frames]
    pseudo-probabilities over ``frame_signal`` frames (``win`` samples from
    ``i * hop``, the tail zero-padded).  Frame log-RMS goes through a
    sigmoid between an adaptive noise floor and ``dynamic_range_db`` above
    it; the floor is the mean of the frames at or below the mean level
    (sort-free), per row of a batch."""
    win = int(sample_rate * win_ms / 1000.0)
    hop = int(sample_rate * hop_ms / 1000.0)
    frames = frame_signal(y.float(), win, hop)                  # [.., n, win]
    rms_db = 10.0 * torch.log10(torch.mean(frames * frames, dim=-1) + 1e-10)
    rms_db = torch.clamp(rms_db, min=floor_db)
    mean_db = torch.mean(rms_db, dim=-1, keepdim=True)
    low = rms_db <= mean_db
    noise_floor = (torch.where(low, rms_db, torch.zeros_like(rms_db))
                   .sum(-1, keepdim=True)
                   / torch.clamp(low.sum(-1, keepdim=True), min=1))
    lo = torch.clamp(noise_floor + 9.0, min=floor_db + 3.0)
    return torch.sigmoid((rms_db - lo) / (dynamic_range_db / 10.0))


class EnergyVad(nn.Module):
    """:func:`energy_vad_probs` behind the neural VADs' ``probs`` contract
    ([T] or [B, T] waveforms), at the pipeline's window and hop.  It has
    ``num_frames(T, win, hop)`` frames, a few fewer than the centred
    ``T//hop + 1`` of the log-mel VADs; the per-chunk program reads core
    frames well inside them, and ``chunked_framewise`` handles the
    shortfall as the JAX package's chunk stitch does."""

    def __init__(self, sample_rate: int = 16000, win_ms: float = 25.0,
                 hop_ms: float = 10.0):
        super().__init__()
        self.sample_rate = sample_rate
        self.win_ms = win_ms
        self.hop_ms = hop_ms

    def probs(self, y: torch.Tensor) -> torch.Tensor:
        return energy_vad_probs(y, self.sample_rate, self.win_ms, self.hop_ms)

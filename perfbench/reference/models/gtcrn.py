"""GTCRN speech enhancement (ERB + SFE + TRA + grouped temporal convs +
dual-path grouped RNNs), the JAX package's ``models/gtcrn.py`` as an
``nn.Module``.

One published width: the DNS3 architecture (23.67 K parameters, 33 MMACs a
frame): 65 pass-through bins and 64 ERB bands, 16 channels, 33 bins after
the encoder's two strided convolutions, three grouped temporal conv blocks
(dilations 1, 2, 5) each way, two DPGRNNs.  The module tree reproduces the
checkpoint's ``state_dict`` keys, so ``weights/gtcrn_mc.npz`` loads with a
strict ``load_state_dict`` (``models/port.py::load_gtcrn``).

The GRUs are ``nn.GRU`` (cuDNN on the card): torch's gate order and math
(r, z, n; ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``) are those of
the JAX package's ``gru_sequence``.  Ten of them run over time (one per
temporal recurrent attention, one per inter-RNN half), so a 360 s chunk is
ten recurrences of 22,501 steps; the intra-RNNs run over the 33 bins.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, layer_norm_apply

_ENC_GT_DILATIONS = (1, 2, 5)
_DEC_GT_DILATIONS = (5, 2, 1)
_LOW_BINS = 65    # bins below the ERB bands, passed through


def erb_filterbank(
    low_bins: int = 65, n_erb: int = 64, nfft: int = 512,
    high_hz: float = 8000.0, fs: float = 16000.0,
) -> np.ndarray:
    """Triangular filterbank on the ERB-rate scale, [n_erb, nfft//2+1-low_bins].

    Independent construction of the fixed (non-trainable) analysis matrix the
    reference bakes into ``erb_fc`` (``gtcrn.py:30-49``): band centers equally
    spaced in ERB-rate between the low cut (bin ``low_bins``) and ``high_hz``,
    triangles between neighboring centers, half-triangles at both edges (the
    last band is the complement of its neighbor so the rows tile to 1).
    A checkpoint overwrites it; a net trained from scratch starts from it
    (``train/init.py``).
    """
    hz2erb = lambda f: 21.4 * np.log10(0.00437 * np.asarray(f) + 1.0)
    erb2hz = lambda e: (10.0 ** (np.asarray(e) / 21.4) - 1.0) / 0.00437
    low_hz = low_bins / nfft * fs
    centers = np.linspace(hz2erb(low_hz), hz2erb(high_hz), n_erb)
    bins = np.round(erb2hz(centers) / fs * nfft).astype(int)
    n_freqs = nfft // 2 + 1
    fb = np.zeros((n_erb, n_freqs), dtype=np.float32)
    eps = 1e-12
    # first band: falling edge only
    j = np.arange(bins[0], bins[1])
    fb[0, bins[0]:bins[1]] = (bins[1] - j + eps) / (bins[1] - bins[0] + eps)
    # interior bands: rising + falling triangles
    for i in range(1, n_erb - 1):
        j = np.arange(bins[i - 1], bins[i])
        fb[i, bins[i - 1]:bins[i]] = (j - bins[i - 1] + eps) / (bins[i] - bins[i - 1] + eps)
        j = np.arange(bins[i], bins[i + 1])
        fb[i, bins[i]:bins[i + 1]] = (bins[i + 1] - j + eps) / (bins[i + 1] - bins[i] + eps)
    # last band: complement of its neighbor over the final span
    fb[-1, bins[-2]:bins[-1] + 1] = 1.0 - fb[-2, bins[-2]:bins[-1] + 1]
    return np.abs(fb[:, low_bins:])


class ERB(nn.Module):
    """ERB analysis [.., 257] -> [.., 65 + 64] and synthesis back."""

    def __init__(self):
        super().__init__()
        self.erb_fc = nn.Linear(257 - _LOW_BINS, 64, bias=False)
        self.ierb_fc = nn.Linear(64, 257 - _LOW_BINS, bias=False)

    def bm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., :_LOW_BINS], self.erb_fc(x[..., _LOW_BINS:])],
                         dim=-1)

    def bs(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., :_LOW_BINS], self.ierb_fc(x[..., _LOW_BINS:])],
                         dim=-1)


def sfe(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Subband feature extraction: [B, C, T, F] -> [B, kernel*C, T, F], each
    bin's ``kernel`` frequency neighbours stacked with the channel varying
    slowest (torch ``Unfold`` order)."""
    b, c, t, f = x.shape
    half = (kernel - 1) // 2
    xp = F.pad(x, (half, half))
    return torch.stack([xp[..., i:i + f] for i in range(kernel)], dim=2
                       ).reshape(b, c * kernel, t, f)


class TRA(nn.Module):
    """Temporal recurrent attention: a GRU over the per-frame energy of each
    channel gates the channel."""

    def __init__(self, c: int):
        super().__init__()
        self.att_gru = nn.GRU(c, 2 * c, batch_first=True)
        self.att_fc = nn.Linear(2 * c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        seq = (x * x).mean(dim=-1).transpose(1, 2).contiguous()    # [B, T, C]
        at, _ = self.att_gru(seq)
        gate = torch.sigmoid(self.att_fc(at).transpose(1, 2))      # [B, C, T]
        return x * gate[..., None]


class ConvBlock(nn.Module):
    """(De)convolution + BatchNorm + PReLU, or Tanh for the last block."""

    def __init__(self, c_in: int, c_out: int, kernel, stride, padding,
                 groups: int = 1, deconv: bool = False, is_last: bool = False):
        super().__init__()
        conv = nn.ConvTranspose2d if deconv else nn.Conv2d
        self.conv = conv(c_in, c_out, kernel, stride, padding, groups=groups)
        self.bn = BatchNorm(c_out)
        self.act = None if is_last else nn.PReLU()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return torch.tanh(x) if self.act is None else self.act(x)


class GTConvBlock(nn.Module):
    """Grouped temporal conv block: half the channels go through SFE,
    pointwise, causal dilated depthwise (front pad ``2 * dilation`` frames),
    pointwise and TRA; the output interleaves them with the other half
    (channel shuffle).  In the decoder the convolutions are transposed ones
    (the pointwise ones are the same math in the transposed weight layout;
    the depthwise one takes ``padding=(2 * dilation, 1)`` after the same
    front pad)."""

    def __init__(self, dilation: int, deconv: bool = False):
        super().__init__()
        conv = nn.ConvTranspose2d if deconv else nn.Conv2d
        half, hidden = 8, 16
        self.dilation = dilation
        self.point_conv1 = conv(half * 3, hidden, 1)
        self.point_bn1 = BatchNorm(hidden)
        self.point_act = nn.PReLU()
        self.depth_conv = conv(hidden, hidden, (3, 3), 1,
                               (2 * dilation, 1) if deconv else (0, 1),
                               dilation=(dilation, 1), groups=hidden)
        self.depth_bn = BatchNorm(hidden)
        self.depth_act = nn.PReLU()
        self.point_conv2 = conv(hidden, half, 1)
        self.point_bn2 = BatchNorm(half)
        self.tra = TRA(half)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[1]
        x1, x2 = x[:, :c // 2], x[:, c // 2:]
        h = self.point_act(self.point_bn1(self.point_conv1(sfe(x1))))
        h = F.pad(h, (0, 0, 2 * self.dilation, 0))
        h = self.depth_act(self.depth_bn(self.depth_conv(h)))
        h = self.tra(self.point_bn2(self.point_conv2(h)))
        b, ch, t, f = h.shape
        return torch.stack([h, x2], dim=2).reshape(b, 2 * ch, t, f)


class GRNN(nn.Module):
    """Grouped RNN: two half-width GRUs on the two halves of the features."""

    def __init__(self, input_size: int, hidden: int, bidirectional: bool):
        super().__init__()
        self.rnn1 = nn.GRU(input_size // 2, hidden // 2, batch_first=True,
                           bidirectional=bidirectional)
        self.rnn2 = nn.GRU(input_size // 2, hidden // 2, batch_first=True,
                           bidirectional=bidirectional)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.shape[-1]
        y1, _ = self.rnn1(x[..., :d // 2].contiguous())
        y2, _ = self.rnn2(x[..., d // 2:].contiguous())
        return torch.cat([y1, y2], dim=-1)


class DPGRNN(nn.Module):
    """Dual-path grouped RNN: a bidirectional intra-RNN over the bins (batch
    B*T) and a unidirectional inter-RNN over time (batch B*F), each with a
    Linear, a LayerNorm over (bins, channels) and a residual."""

    def __init__(self):
        super().__init__()
        self.intra_rnn = GRNN(16, 8, bidirectional=True)
        self.intra_fc = nn.Linear(16, 16)
        self.intra_ln = nn.LayerNorm((33, 16), eps=1e-8)
        self.inter_rnn = GRNN(16, 16, bidirectional=False)
        self.inter_fc = nn.Linear(16, 16)
        self.inter_ln = nn.LayerNorm((33, 16), eps=1e-8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, t, f = x.shape
        x = x.permute(0, 2, 3, 1)                                   # [B, T, F, C]
        intra = self.intra_fc(self.intra_rnn(x.reshape(b * t, f, c)))
        intra = layer_norm_apply(intra.reshape(b, t, f, c),
                                 self.intra_ln.weight, self.intra_ln.bias)
        x = x + intra
        inter = x.transpose(1, 2).reshape(b * f, t, c)
        inter = self.inter_fc(self.inter_rnn(inter))
        inter = layer_norm_apply(inter.reshape(b, f, t, c).transpose(1, 2),
                                 self.inter_ln.weight, self.inter_ln.bias)
        return (x + inter).permute(0, 3, 1, 2)                      # [B, C, T, F]


class Encoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.en_convs = nn.ModuleList([
            ConvBlock(9, 16, (1, 5), (1, 2), (0, 2)),
            ConvBlock(16, 16, (1, 5), (1, 2), (0, 2), groups=2),
            *(GTConvBlock(dilation=d) for d in _ENC_GT_DILATIONS)])


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.de_convs = nn.ModuleList([
            *(GTConvBlock(dilation=d, deconv=True) for d in _DEC_GT_DILATIONS),
            ConvBlock(16, 16, (1, 5), (1, 2), (0, 2), groups=2, deconv=True),
            ConvBlock(16, 2, (1, 5), (1, 2), (0, 2), deconv=True, is_last=True)])


class GTCRN(nn.Module):
    """Spectrum [B, 257, T, 2] (real, imag) -> enhanced spectrum of the same
    shape: a complex ratio mask from the encoder, two DPGRNNs and the
    decoder with additive skips."""

    def __init__(self, low_bins: int = 65):
        if low_bins != _LOW_BINS:
            raise ValueError(f"GTCRN's encoder is {_LOW_BINS} + 64 bins wide: "
                             f"low_bins must be {_LOW_BINS}, got {low_bins}")
        super().__init__()
        self.low_bins = low_bins
        self.erb = ERB()
        self.encoder = Encoder()
        self.dpgrnn1 = DPGRNN()
        self.dpgrnn2 = DPGRNN()
        self.decoder = Decoder()

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        real = spec[..., 0].transpose(1, 2)                          # [B, T, F]
        imag = spec[..., 1].transpose(1, 2)
        mag = torch.sqrt(real * real + imag * imag + 1e-12)
        feat = sfe(self.erb.bm(torch.stack([mag, real, imag], dim=1)))

        skips = []
        h = feat
        for blk in self.encoder.en_convs:
            h = blk(h)
            skips.append(h)
        h = self.dpgrnn2(self.dpgrnn1(h))
        for i, blk in enumerate(self.decoder.de_convs):
            h = blk(h + skips[4 - i])
        m = self.erb.bs(h)                                           # [B, 2, T, F]

        m_r, m_i = m[:, 0], m[:, 1]
        out_r = real * m_r - imag * m_i
        out_i = imag * m_r + real * m_i
        return torch.stack([out_r, out_i], dim=-1).transpose(1, 2)  # [B, F, T, 2]

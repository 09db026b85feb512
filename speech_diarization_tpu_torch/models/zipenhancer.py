"""ZipEnhancer-class noise suppressor, the JAX package's
``models/zipenhancer.py`` as an ``nn.Module``: STFT -> power-law-compressed
complex input -> conv encoder -> dual-path (time, then frequency) transformer
blocks -> magnitude-mask and phase decoders -> iSTFT, wav ``[B, L]`` ->
wav ``[B, L]`` at 16 kHz.

The module tree reproduces the checkpoint's ``state_dict`` keys
(``blk0.time.att.qkv.weight`` ...), so ``weights/zipenhancer_mc.npz`` loads
with a strict ``load_state_dict`` (``models/port.py::load_zipenhancer``).

JAX semantics kept where torch's defaults differ: GELU is the tanh
approximation, the layer norms use eps 1e-6 (population variance, as
``F.layer_norm`` has it), the magnitude is compressed as ``(|X| + 1e-9) **
0.3`` and restored from ``max(mag_c * mask, 1e-9) ** (1 / 0.3)``, and phases
stay unit (cos, sin) pairs.  The attention is
``F.scaled_dot_product_attention``: on the card its float32 path does not
materialize the ``[B*F, heads, T, T]`` scores of the time path (10.7 GB a
64-window batch when written as two products around a softmax).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..dsp.stft import istft_ri, stft_ri


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class _Attention(nn.Module):
    """Pre-LN multi-head self-attention with a residual, over [N, S, C]."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln = nn.LayerNorm(c, eps=1e-6)
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, c = x.shape
        qkv = self.qkv(self.ln(x)).reshape(n, s, 3, self.heads, c // self.heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)                    # [N, H, S, Dh]
        out = F.scaled_dot_product_attention(q, k, v)
        return x + self.proj(out.transpose(1, 2).reshape(n, s, c))


class _FFN(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.ln = nn.LayerNorm(c, eps=1e-6)
        self.fc1 = nn.Linear(c, 2 * c)
        self.fc2 = nn.Linear(2 * c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fc2(_gelu(self.fc1(self.ln(x))))


class _Path(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.att = _Attention(c, heads)
        self.ffn = _FFN(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ffn(self.att(x))


class _Block(nn.Module):
    """Time path (sequences over frames, batched over B*F), then frequency
    path (sequences over bins, batched over B*T), on h [B, T, F, C]."""

    def __init__(self, c: int, heads: int):
        super().__init__()
        self.time = _Path(c, heads)
        self.freq = _Path(c, heads)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        b, t, f, c = h.shape
        ht = self.time(h.transpose(1, 2).reshape(b * f, t, c))
        h = ht.reshape(b, f, t, c).transpose(1, 2)
        return self.freq(h.reshape(b * t, f, c)).reshape(b, t, f, c)


def _container(**mods: nn.Module) -> nn.Module:
    m = nn.Module()
    for name, mod in mods.items():
        m.add_module(name, mod)
    return m


class ZipEnhancerModel(nn.Module):
    """Enhancer: noisy wav [B, L] -> enhanced wav [B, L] at 16 kHz."""

    def __init__(self, n_fft: int = 400, hop: int = 100, channels: int = 64,
                 blocks: int = 4, heads: int = 4, compress: float = 0.3,
                 sample_rate: int = 16000):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.sample_rate = sample_rate
        self.n_blocks = blocks
        self.compress = compress
        self.n_bins = n_fft // 2 + 1
        c = channels
        self.enc = _container(conv1=nn.Conv2d(2, c, (3, 3), padding=(1, 1)),
                              conv2=nn.Conv2d(c, c, (1, 3), stride=(1, 2),
                                              padding=(0, 1)))
        for i in range(blocks):
            self.add_module(f"blk{i}", _Block(c, heads))

        def deconv():
            return nn.ConvTranspose2d(c, c, (1, 3), stride=(1, 2), padding=(0, 1))

        self.mask = _container(deconv=deconv(), out=nn.Conv2d(c, 1, 1))
        self.phase = _container(deconv=deconv(), out_r=nn.Conv2d(c, 1, 1),
                                out_i=nn.Conv2d(c, 1, 1))

    def forward(self, wavs: torch.Tensor) -> torch.Tensor:
        spec = stft_ri(wavs, self.n_fft, self.hop)             # [B, F, T, 2]
        re, im = spec[..., 0], spec[..., 1]
        mag = torch.sqrt(re * re + im * im + 1e-12)
        mag_c = torch.pow(mag + 1e-9, self.compress)
        x = torch.stack([mag_c * (re / mag), mag_c * (im / mag)], dim=1)
        x = _gelu(self.enc.conv1(x.transpose(2, 3)))           # [B, C, T, F]
        x = _gelu(self.enc.conv2(x))
        h = x.permute(0, 2, 3, 1)                              # [B, T, F', C]
        for i in range(self.n_blocks):
            h = getattr(self, f"blk{i}")(h)
        y = h.permute(0, 3, 1, 2)                              # [B, C, T, F']

        m = _gelu(self.mask.deconv(y)[..., :self.n_bins])
        mask = 2.0 * torch.sigmoid(self.mask.out(m))[:, 0]     # [B, T, F]
        ph = _gelu(self.phase.deconv(y)[..., :self.n_bins])
        pr = self.phase.out_r(ph)[:, 0]
        pi = self.phase.out_i(ph)[:, 0]
        norm = torch.sqrt(pr * pr + pi * pi + 1e-8)
        mag_enh = torch.pow(torch.clamp(mag_c * mask.transpose(1, 2), min=1e-9),
                            1.0 / self.compress)
        spec_enh = torch.stack([mag_enh * (pr / norm).transpose(1, 2),
                                mag_enh * (pi / norm).transpose(1, 2)], dim=-1)
        return istft_ri(spec_enh, self.n_fft, self.hop, length=wavs.shape[-1])

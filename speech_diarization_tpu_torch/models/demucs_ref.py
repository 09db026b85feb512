"""Hybrid Transformer Demucs (HTDemucs) as an ``nn.Module``: the JAX
package's ``models/demucs_ref.py``.

The architecture of the MVSEP-CDX23 dialog / effect / music checkpoints
(Rouard, Massa & Defossez, "Hybrid Transformers for Music Source
Separation", ICASSP 2023): a spectral branch (normalized Hann STFT, complex
as channels, four strided frequency-axis encoder stages with a ``DConv``
residual stack and a GLU rewrite, a frequency embedding after stage 0) and a
time branch of the same topology over samples, both 1x1-upsampled to 512
channels into a cross-domain transformer (interleaved self- and
cross-attention layers, pre-norm, LayerScale, a GroupNorm over the sequence),
then mirrored decoders with U-Net skips; the spectral output is a
complex-as-channels mask through the inverse STFT, and the two branches sum
per source.  ``forward(mix [B, AC, T]) -> [B, S, AC, T]``, each example
normalized by its own mean and standard deviation.

The module tree reproduces ``demucs.htdemucs.HTDemucs``'s ``state_dict``
names (``encoder.0.dconv.layers.0.3.weight``, ``crosstransformer.layers.1.
cross_attn.in_proj_weight`` ...), the keys of the JAX parameter dict, so a
``.th`` package's ``state`` loads with a strict ``load_state_dict``
(``models/port_demucs.py``).  JAX semantics kept: population statistics in
every norm and in the input normalization, exact (erf) GELU, and the JAX
graph's encoder rewrite without padding.  The attention is
``F.scaled_dot_product_attention``: the spectral bottleneck of a 10 s chunk
has 3,448 tokens, and its float32 scores would take 380 MB a chunk and
head group.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..dsp.ola import overlap_add


# ---------------------------------------------------------------------------
# small primitives
# ---------------------------------------------------------------------------

def group_norm_1(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float = 1e-5) -> torch.Tensor:
    """``nn.GroupNorm(1, C)`` over ``[B, C, *spatial]``: channels and
    positions normalized jointly, population variance."""
    return F.group_norm(x, 1, weight, bias, eps)


class GroupNorm1(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_1(x, self.weight, self.bias)


class LayerScale(nn.Module):
    """Per-channel scale on axis ``dim`` (1 in a DConv, -1 in the
    transformer)."""

    def __init__(self, c: int, dim: int = 1):
        super().__init__()
        self.dim = dim
        self.scale = nn.Parameter(torch.full((c,), 1e-3), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * (self.scale[:, None] if self.dim == 1 else self.scale)


class GELU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(x)


class GLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.glu(x, dim=1)


class DConv(nn.Module):
    """Residual stack over [B, C, T]: ``layers.{d}`` = (dilated conv to
    C // compress, GroupNorm(1), GELU, 1x1 conv to 2C, GroupNorm(1), GLU,
    LayerScale) at dilation 2^d."""

    def __init__(self, c: int, depth: int = 2, compress: int = 8, kernel: int = 3):
        super().__init__()
        hid = c // compress
        self.layers = nn.ModuleList()
        for d in range(depth):
            dil = 2 ** d
            self.layers.append(nn.Sequential(
                nn.Conv1d(c, hid, kernel, dilation=dil, padding=dil * (kernel // 2)),
                GroupNorm1(hid), GELU(), nn.Conv1d(hid, 2 * c, 1), GroupNorm1(2 * c),
                GLU(), LayerScale(c)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x)
        return x


class HEncLayer(nn.Module):
    """Strided conv (frequency axis of [B, C, F, T], or samples of
    [B, C, T]) -> GELU -> DConv -> 1x1 GLU rewrite."""

    def __init__(self, chin: int, chout: int, freq: bool, kernel: int, stride: int,
                 context_enc: int, dconv_depth: int, dconv_comp: int):
        super().__init__()
        self.freq, self.stride = freq, stride
        rw = 1 + 2 * context_enc
        if freq:
            self.conv = nn.Conv2d(chin, chout, (kernel, 1), stride=(stride, 1),
                                  padding=(kernel // 4, 0))
            self.rewrite = nn.Conv2d(chout, 2 * chout, rw)
        else:
            self.conv = nn.Conv1d(chin, chout, kernel, stride=stride,
                                  padding=kernel // 4)
            self.rewrite = nn.Conv1d(chout, 2 * chout, rw)
        self.dconv = DConv(chout, dconv_depth, dconv_comp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = F.gelu(self.conv(x))
        if self.freq:
            b, c, fr, t = y.shape
            yd = self.dconv(y.permute(0, 2, 1, 3).reshape(b * fr, c, t))
            y = yd.reshape(b, fr, c, t).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self.rewrite(y), dim=1)


class HDecLayer(nn.Module):
    """Skip add -> context GLU rewrite -> transposed conv, trimmed; GELU
    unless it is the last layer."""

    def __init__(self, chin: int, chout: int, freq: bool, last: bool, kernel: int,
                 stride: int, context: int):
        super().__init__()
        self.freq, self.last, self.pad = freq, last, kernel // 4
        rw = 1 + 2 * context
        # the transposed convolutions have no padding: the output is trimmed
        if freq:
            self.rewrite = nn.Conv2d(chin, 2 * chin, rw, padding=context)
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel, 1), stride=(stride, 1))
        else:
            self.rewrite = nn.Conv1d(chin, 2 * chin, rw, padding=context)
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel, stride=stride)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, length: int) -> torch.Tensor:
        z = self.conv_tr(F.glu(self.rewrite(x + skip), dim=1))
        pad = self.pad
        z = z[..., pad:-pad, :] if self.freq else z[..., pad:pad + length]
        return z if self.last else F.gelu(z)


# ---------------------------------------------------------------------------
# cross-domain transformer
# ---------------------------------------------------------------------------

def create_sin_embedding(length: int, dim: int, max_period: float = 10000.0,
                         device=None) -> torch.Tensor:
    """1-D sinusoidal embedding [T, dim]: half cos, half sin."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    half = dim // 2
    adim = torch.arange(half, dtype=torch.float32, device=device)[None, :]
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def create_2d_sin_embedding(d_model: int, height: int, width: int,
                            max_period: float = 10000.0, device=None) -> torch.Tensor:
    """[1, d_model, height, width]: the first half of the channels encodes
    the width (time), the second half the height (frequency), sin and cos
    interleaved."""
    half = d_model // 2
    div = torch.exp(torch.arange(0.0, half, 2, device=device)
                    * -(math.log(max_period) / half))
    pos_w = torch.arange(width, dtype=torch.float32, device=device)[:, None]
    pos_h = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    pe = torch.zeros((d_model, height, width), dtype=torch.float32, device=device)
    pe[0:half:2] = torch.sin(pos_w * div).T[:, None, :]
    pe[1:half:2] = torch.cos(pos_w * div).T[:, None, :]
    pe[half::2] = torch.sin(pos_h * div).T[:, :, None]
    pe[half + 1::2] = torch.cos(pos_h * div).T[:, :, None]
    return pe[None]


class MultiheadAttention(nn.Module):
    """``nn.MultiheadAttention`` (batch first, one packed in_proj) as SDPA."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim), requires_grad=False)
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim), requires_grad=False)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            bsz, t, c = x.shape
            return F.linear(x, w, b).reshape(bsz, t, self.heads, c // self.heads
                                             ).transpose(1, 2)

        out = F.scaled_dot_product_attention(heads(q, wq, bq), heads(k, wk, bk),
                                             heads(v, wv, bv))
        bsz, h, t, hd = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(bsz, t, h * hd))


def _group_norm_seq(x: torch.Tensor, norm: GroupNorm1) -> torch.Tensor:
    """GroupNorm(1) on [B, T, C]: over (T, C) jointly."""
    return group_norm_1(x.transpose(1, 2), norm.weight, norm.bias).transpose(1, 2)


class TransformerLayer(nn.Module):
    """A self-attention (``cross=False``) or cross-attention layer: pre-norm,
    LayerScale, GELU MLP, a GroupNorm(1) out-norm."""

    def __init__(self, d: int, heads: int, hidden: int, cross: bool):
        super().__init__()
        self.cross = cross
        attn = MultiheadAttention(d, heads)
        if cross:
            self.cross_attn = attn
        else:
            self.self_attn = attn
        self.linear1 = nn.Linear(d, hidden)
        self.linear2 = nn.Linear(hidden, d)
        for nm in ("norm1", "norm2") + (("norm3",) if cross else ()):
            self.add_module(nm, nn.LayerNorm(d, eps=1e-5))
        self.norm_out = GroupNorm1(d)
        self.gamma_1 = LayerScale(d, dim=-1)
        self.gamma_2 = LayerScale(d, dim=-1)

    def forward(self, x: torch.Tensor, k: torch.Tensor | None = None) -> torch.Tensor:
        if self.cross:
            kn = self.norm2(k)
            x = x + self.gamma_1(self.cross_attn(self.norm1(x), kn, kn))
            h = self.norm3(x)
        else:
            xn = self.norm1(x)
            x = x + self.gamma_1(self.self_attn(xn, xn, xn))
            h = self.norm2(x)
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(h))))
        return _group_norm_seq(x, self.norm_out)


class CrossTransformerEncoder(nn.Module):
    """Even layers self-attend on each branch; odd layers attend across
    (the spectral tokens to the time tokens and back)."""

    def __init__(self, d: int, layers: int, heads: int, hidden: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(d, eps=1e-5)
        self.norm_in_t = nn.LayerNorm(d, eps=1e-5)
        self.layers = nn.ModuleList(
            [TransformerLayer(d, heads, hidden, i % 2 == 1) for i in range(layers)])
        self.layers_t = nn.ModuleList(
            [TransformerLayer(d, heads, hidden, i % 2 == 1) for i in range(layers)])

    def forward(self, x: torch.Tensor, xt: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, C, F, T] spectral tokens, xt [B, C, T2] time tokens."""
        b, c, fr, t1 = x.shape
        pos2d = create_2d_sin_embedding(c, fr, t1, device=x.device)
        pos2d = pos2d.permute(0, 3, 2, 1).reshape(1, t1 * fr, c)
        x = self.norm_in(x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c)) + pos2d
        xt = xt.transpose(1, 2)
        xt = self.norm_in_t(xt) + create_sin_embedding(xt.shape[1], c,
                                                       device=x.device)[None]
        for layer, layer_t in zip(self.layers, self.layers_t):
            if layer.cross:
                x, xt = layer(x, xt), layer_t(xt, x)
            else:
                x, xt = layer(x), layer_t(xt)
        return x.reshape(b, t1, fr, c).permute(0, 3, 2, 1), xt.transpose(1, 2)


# ---------------------------------------------------------------------------
# STFT front and back
# ---------------------------------------------------------------------------

_WIN: dict = {}


def _hann(nfft: int, device) -> torch.Tensor:
    """``numpy.hanning(nfft + 1)[:-1]`` (periodic Hann) on ``device``."""
    key = (nfft, str(device))
    if key not in _WIN:
        _WIN[key] = torch.from_numpy(
            np.hanning(nfft + 1)[:-1].astype(np.float32)).to(device)
    return _WIN[key]


def _spec(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """[B, C, T] -> complex [B, C, nfft // 2, ceil(T / hop)]: reflect pads of
    ``hop // 2 * 3`` and ``nfft // 2``, a periodic Hann, ``rfft /
    sqrt(nfft)``, the last bin dropped and two frames trimmed each side."""
    t = x.shape[-1]
    le = int(math.ceil(t / hop))
    pad = hop // 2 * 3
    x = F.pad(x, (pad, pad + le * hop - t), mode="reflect")
    x = F.pad(x, (nfft // 2, nfft // 2), mode="reflect")
    frames = x.unfold(-1, nfft, hop) * _hann(nfft, x.device)   # [B, C, Fr, nfft]
    z = torch.fft.rfft(frames, dim=-1) / math.sqrt(nfft)
    return z.transpose(-1, -2)[..., :-1, 2:2 + le]


def _ispec(z: torch.Tensor, length: int, nfft: int, hop: int) -> torch.Tensor:
    """complex [..., nfft // 2, frames] -> [..., length]: the inverse of
    :func:`_spec` (overlap-add divided by the window-square sum clamped at
    1e-8, then the pads undone).  The DC bin's imaginary part is dropped
    first: a real inverse FFT ignores it on the CPU (the JAX package's
    ``irfft`` too), but cuFFT's does not, and the mask the net writes there
    is not zero (1.7e-3 of the output's peak between an H100 and the CPU
    on seeded weights)."""
    z = torch.cat([z[..., :1, :].real.to(z.dtype), z[..., 1:, :]], dim=-2)
    z = F.pad(z, (2, 2, 0, 1))
    pad = hop // 2 * 3
    le = hop * int(math.ceil(length / hop)) + 2 * pad
    win = _hann(nfft, z.device)
    frames = torch.fft.irfft(z.transpose(-1, -2), n=nfft, dim=-1)
    frames = frames * (math.sqrt(nfft) * win)                  # [..., Fr, nfft]
    lead = frames.shape[:-2]
    n_frames = frames.shape[-2]
    out = overlap_add(frames.reshape(-1, n_frames, nfft), hop)
    wsq = overlap_add((win * win).expand(1, n_frames, nfft), hop)
    out = (out / torch.clamp(wsq, min=1e-8))[:, nfft // 2:nfft // 2 + le]
    return out.reshape(*lead, le)[..., pad:pad + length]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class HTDemucsRef(nn.Module):
    """``forward(mix [B, AC, T]) -> [B, S, AC, T]``.  Constructor arguments
    and defaults are the JAX class's (the inference-relevant subset of
    ``demucs.htdemucs.HTDemucs.__init__``: the released ``htdemucs``
    hyperparameters with the CDX23 sources)."""

    def __init__(self, sources: tuple[str, ...] = ("music", "effect", "dialog"),
                 audio_channels: int = 2, channels: int = 48, growth: int = 2,
                 depth: int = 4, nfft: int = 4096, kernel_size: int = 8,
                 stride: int = 4, context: int = 1, context_enc: int = 0,
                 bottom_channels: int = 512, t_layers: int = 5, t_heads: int = 8,
                 t_hidden_scale: float = 4.0, dconv_depth: int = 2,
                 dconv_comp: int = 8, freq_emb_scale: float = 0.2,
                 samplerate: int = 44100, segment: float = 10.0):
        super().__init__()
        self.sources = tuple(sources)
        self.ac = audio_channels
        self.depth = depth
        self.nfft, self.hop = nfft, nfft // 4
        self.bottom = bottom_channels
        self.freq_emb_scale = freq_emb_scale
        self.samplerate, self.segment = samplerate, segment
        n_src = len(self.sources)
        enc_kw = dict(kernel=kernel_size, stride=stride, context_enc=context_enc,
                      dconv_depth=dconv_depth, dconv_comp=dconv_comp)
        dec_kw = dict(kernel=kernel_size, stride=stride, context=context)
        self.encoder, self.tencoder = nn.ModuleList(), nn.ModuleList()
        dec, tdec = [], []
        chin_t, chin_z, chout = audio_channels, audio_channels * 2, channels
        for i in range(depth):
            self.encoder.append(HEncLayer(chin_z, chout, True, **enc_kw))
            self.tencoder.append(HEncLayer(chin_t, chout, False, **enc_kw))
            out_z = audio_channels * 2 * n_src if i == 0 else chin_z
            out_t = audio_channels * n_src if i == 0 else chin_t
            # decoder.0 is the deepest layer
            dec.insert(0, HDecLayer(chout, out_z, True, i == 0, **dec_kw))
            tdec.insert(0, HDecLayer(chout, out_t, False, i == 0, **dec_kw))
            chin_t, chin_z, chout = chout, chout, chout * growth
        self.decoder, self.tdecoder = nn.ModuleList(dec), nn.ModuleList(tdec)
        self.freq_emb = nn.Module()
        self.freq_emb.embedding = nn.Embedding(nfft // 2 // stride, channels)
        cbot = channels * growth ** (depth - 1)
        if bottom_channels:
            self.channel_upsampler = nn.Conv1d(cbot, bottom_channels, 1)
            self.channel_downsampler = nn.Conv1d(bottom_channels, cbot, 1)
            self.channel_upsampler_t = nn.Conv1d(cbot, bottom_channels, 1)
            self.channel_downsampler_t = nn.Conv1d(bottom_channels, cbot, 1)
        d = bottom_channels or cbot
        self.crosstransformer = CrossTransformerEncoder(
            d, t_layers, t_heads, int(t_hidden_scale * d))

    def manifest(self) -> dict[str, tuple[int, ...]]:
        """state_dict key -> shape (the strict-load contract)."""
        return {k: tuple(v.shape) for k, v in self.state_dict().items()}

    def param_count(self) -> int:
        return sum(int(np.prod(s)) for s in self.manifest().values())

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        b, ac, length = mix.shape
        n_src = len(self.sources)
        z = _spec(mix, self.nfft, self.hop)                    # [B, AC, F, T]
        fq, tf = z.shape[-2:]
        # complex as channels: (c0.re, c0.im, c1.re, c1.im)
        mag = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, ac * 2, fq, tf)
        mean = mag.mean(dim=(1, 2, 3), keepdim=True)
        std = mag.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = (mag - mean) / (1e-5 + std)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True, correction=0)
        xt = (mix - meant) / (1e-5 + stdt)

        saved, saved_t, lengths_t = [], [], []
        for i in range(self.depth):
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[i](xt)
            saved_t.append(xt)
            x = self.encoder[i](x)
            if i == 0:
                emb = self.freq_emb.embedding.weight[:x.shape[-2]] * 10.0
                x = x + self.freq_emb_scale * emb.T[None, :, :, None]
            saved.append(x)

        if self.bottom:
            bb, cc, ff, tt = x.shape
            x = self.channel_upsampler(x.reshape(bb, cc, ff * tt)).reshape(
                bb, self.bottom, ff, tt)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if self.bottom:
            bb, cc, ff, tt = x.shape
            x = self.channel_downsampler(x.reshape(bb, cc, ff * tt)).reshape(
                bb, -1, ff, tt)
            xt = self.channel_downsampler_t(xt)

        for j in range(self.depth):
            x = self.decoder[j](x, saved.pop(-1), 0)
            xt = self.tdecoder[j](xt, saved_t.pop(-1), lengths_t.pop(-1))

        x = x.reshape(b, n_src, ac * 2, fq, tf) * std[:, None] + mean[:, None]
        xs = x.reshape(b, n_src, ac, 2, fq, tf)
        wave_spec = _ispec(torch.complex(xs[:, :, :, 0], xs[:, :, :, 1]),
                           length, self.nfft, self.hop)
        xt = xt.reshape(b, n_src, ac, length) * stdt[:, None] + meant[:, None]
        return xt + wave_spec

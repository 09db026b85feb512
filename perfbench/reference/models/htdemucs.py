"""Hybrid Transformer Demucs, the plain reference of the demix-dialog
front-end's separator.

The graph of demucs v4 (``demucs/htdemucs.py``, ``demucs/hdemucs.py``,
``demucs/transformer.py``; Rouard, Massa & Defossez, "Hybrid Transformers
for Music Source Separation", arXiv 2211.08553), inference only, at the
hyperparameters of the released ``htdemucs`` with the three sources of the
MVSEP-CDX23 dialog / effect / music nets:

* the spectral branch: ``torch.stft`` (periodic Hann, ``normalized=True``,
  hop ``nfft / 4``) of the reflect-padded mix, the last bin dropped and two
  frames trimmed each side, complex as channels, normalized by its mean and
  standard deviation; four encoder layers (a strided convolution over
  frequency, GELU, a residual ``DConv`` stack over time, a 1x1 GLU rewrite),
  the frequency embedding after the first;
* the time branch: the same over samples, each layer padded to a whole
  stride;
* the cross-domain transformer at ``bottom_channels``: both branches
  upsampled by 1x1 convolutions, LayerNorm plus sinusoidal positions (2-D
  over the spectrogram, 1-D over time), then layers that self-attend within
  each branch (even layers) and cross-attend between them (odd layers), each
  pre-norm with LayerScale, a GELU feed-forward and a GroupNorm(1) out-norm;
* mirrored decoders (skip add, a context-3 GLU rewrite, a transposed
  convolution trimmed by a quarter kernel), the spectral output a
  complex-as-channels mask through ``torch.istft``, added to the time
  branch per source.

Attention is written out: ``softmax(Q K^T / sqrt(d)) V`` per head, in blocks
of queries whose scores take at most ``ATTN_BLOCK_BYTES``.  Everything runs
in float32: building the model turns TF32 off for matrix products and
convolutions (``utils/device.py::disable_tf32``); the control turns it on
again around its window, after the build.

The module tree has ``demucs.htdemucs.HTDemucs``'s ``state_dict`` names
(``encoder.0.dconv.layers.0.3.weight``, ``crosstransformer.layers.1.
cross_attn.in_proj_weight`` ...), which are also the port's, so one draw
loads into both.

Where it follows the port and not demucs v4:

* the input normalizations use the population standard deviation
  (``correction=0``; demucs' ``Tensor.std`` is the unbiased one);
* the DC bin's imaginary part is set to zero before the inverse STFT (a
  real inverse FFT ignores it on the CPU but cuFFT's does not, and the mask
  the net writes there is not zero);
* a mix shorter than ``segment`` runs at its own length (demucs pads it to
  the training segment first).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import disable_tf32

# the largest float32 score block of one attention call, bytes
ATTN_BLOCK_BYTES = 1 << 28


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, Tq, D] x [B, H, Tk, D] x [B, H, Tk, D] -> [B, H, Tq, D]:
    ``softmax(q k^T / sqrt(D)) v`` in blocks of queries."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    rows = max(1, ATTN_BLOCK_BYTES // (4 * b * h * tk))
    kt = k.transpose(-1, -2)
    scale = 1.0 / math.sqrt(d)
    out = []
    for i in range(0, tq, rows):
        scores = torch.matmul(q[:, :, i:i + rows] * scale, kt)
        out.append(torch.matmul(torch.softmax(scores, dim=-1), v))
    return torch.cat(out, dim=2)


class LayerScale(nn.Module):
    """A learned scale per channel (demucs' ``LayerScale``): on axis 1, or
    on the last axis where ``channel_last``."""

    def __init__(self, c: int, channel_last: bool = False):
        super().__init__()
        self.channel_last = channel_last
        self.scale = nn.Parameter(torch.full((c,), 1e-4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * (self.scale if self.channel_last else self.scale[:, None])


class DConv(nn.Module):
    """Residual branches at dilations 1, 2, ...: conv(k 3) to ``c /
    compress``, GroupNorm(1), GELU, conv(1) to ``2 c``, GroupNorm(1), GLU,
    LayerScale."""

    def __init__(self, c: int, depth: int, compress: int):
        super().__init__()
        hid = int(c / compress)
        self.layers = nn.ModuleList()
        for d in range(depth):
            dil = 2 ** d
            self.layers.append(nn.Sequential(
                nn.Conv1d(c, hid, 3, dilation=dil, padding=dil),
                nn.GroupNorm(1, hid), nn.GELU(),
                nn.Conv1d(hid, 2 * c, 1), nn.GroupNorm(1, 2 * c), nn.GLU(1),
                LayerScale(c)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer(x)
        return x


class HEncLayer(nn.Module):
    def __init__(self, chin: int, chout: int, freq: bool, kernel: int, stride: int,
                 context_enc: int, dconv_depth: int, dconv_comp: int):
        super().__init__()
        self.freq, self.stride = freq, stride
        pad = kernel // 4
        if freq:
            self.conv = nn.Conv2d(chin, chout, (kernel, 1), (stride, 1), (pad, 0))
            self.rewrite = nn.Conv2d(chout, 2 * chout, 1 + 2 * context_enc, 1, context_enc)
        else:
            self.conv = nn.Conv1d(chin, chout, kernel, stride, pad)
            self.rewrite = nn.Conv1d(chout, 2 * chout, 1 + 2 * context_enc, 1, context_enc)
        self.dconv = DConv(chout, dconv_depth, dconv_comp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.freq and x.shape[-1] % self.stride:
            x = F.pad(x, (0, self.stride - x.shape[-1] % self.stride))
        y = F.gelu(self.conv(x))
        if self.freq:
            b, c, fr, t = y.shape
            y = self.dconv(y.permute(0, 2, 1, 3).reshape(-1, c, t))
            y = y.view(b, fr, c, t).permute(0, 2, 1, 3)
        else:
            y = self.dconv(y)
        return F.glu(self.rewrite(y), dim=1)


class HDecLayer(nn.Module):
    def __init__(self, chin: int, chout: int, freq: bool, last: bool, kernel: int,
                 stride: int, context: int):
        super().__init__()
        self.freq, self.last, self.pad = freq, last, kernel // 4
        if freq:
            self.rewrite = nn.Conv2d(chin, 2 * chin, 1 + 2 * context, 1, context)
            self.conv_tr = nn.ConvTranspose2d(chin, chout, (kernel, 1), (stride, 1))
        else:
            self.rewrite = nn.Conv1d(chin, 2 * chin, 1 + 2 * context, 1, context)
            self.conv_tr = nn.ConvTranspose1d(chin, chout, kernel, stride)

    def forward(self, x: torch.Tensor, skip: torch.Tensor, length: int) -> torch.Tensor:
        y = F.glu(self.rewrite(x + skip), dim=1)
        z = self.conv_tr(y)
        if self.freq:
            z = z[..., self.pad:-self.pad, :]
        else:
            z = z[..., self.pad:self.pad + length]
        return z if self.last else F.gelu(z)


def create_sin_embedding(length: int, dim: int, device, max_period: float = 10000.0):
    """[length, 1, dim]: cosines then sines of ``pos / max_period ** (i /
    (dim / 2 - 1))``."""
    pos = torch.arange(length, device=device).view(-1, 1, 1)
    half = dim // 2
    adim = torch.arange(half, device=device).view(1, 1, -1)
    phase = pos / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def create_2d_sin_embedding(d_model: int, height: int, width: int, device,
                            max_period: float = 10000.0) -> torch.Tensor:
    """[1, d_model, height, width]: sines and cosines of the width (time) in
    the first half of the channels, of the height (frequency) in the second."""
    pe = torch.zeros(d_model, height, width)
    d = d_model // 2
    div = torch.exp(torch.arange(0.0, d, 2) * -(math.log(max_period) / d))
    pos_w = torch.arange(0.0, width).unsqueeze(1)
    pos_h = torch.arange(0.0, height).unsqueeze(1)
    pe[0:d:2] = torch.sin(pos_w * div).transpose(0, 1).unsqueeze(1).repeat(1, height, 1)
    pe[1:d:2] = torch.cos(pos_w * div).transpose(0, 1).unsqueeze(1).repeat(1, height, 1)
    pe[d::2] = torch.sin(pos_h * div).transpose(0, 1).unsqueeze(2).repeat(1, 1, width)
    pe[d + 1::2] = torch.cos(pos_h * div).transpose(0, 1).unsqueeze(2).repeat(1, 1, width)
    return pe[None].to(device)


class MultiheadAttention(nn.MultiheadAttention):
    """``nn.MultiheadAttention``'s parameters (one packed input projection,
    batch first), applied by :func:`attention`."""

    def __init__(self, dim: int, heads: int):
        super().__init__(dim, heads, batch_first=True)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            bsz, t, c = x.shape
            return F.linear(x, w, b).view(bsz, t, self.num_heads, -1).transpose(1, 2)

        o = attention(heads(q, wq, bq), heads(k, wk, bk), heads(v, wv, bv))
        bsz, h, t, hd = o.shape
        return self.out_proj(o.transpose(1, 2).reshape(bsz, t, h * hd))


class GroupNormSeq(nn.GroupNorm):
    """GroupNorm(1) over a [B, T, C] sequence (demucs' ``MyGroupNorm``)."""

    def __init__(self, c: int):
        super().__init__(1, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.transpose(1, 2)).transpose(1, 2)


class SelfAttentionLayer(nn.Module):
    """demucs' ``MyTransformerEncoderLayer`` with ``norm_first``,
    ``norm_out`` and ``layer_scale``."""

    def __init__(self, d: int, heads: int, hidden: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d, heads)
        self.linear1 = nn.Linear(d, hidden)
        self.linear2 = nn.Linear(hidden, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm_out = GroupNormSeq(d)
        self.gamma_1 = LayerScale(d, channel_last=True)
        self.gamma_2 = LayerScale(d, channel_last=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.gamma_1(self.self_attn(h, h, h))
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(self.norm2(x)))))
        return self.norm_out(x)


class CrossAttentionLayer(nn.Module):
    """demucs' ``CrossTransformerEncoderLayer`` with ``norm_first``,
    ``norm_out`` and ``layer_scale``: the queries from one branch, keys and
    values from the other."""

    def __init__(self, d: int, heads: int, hidden: int):
        super().__init__()
        self.cross_attn = MultiheadAttention(d, heads)
        self.linear1 = nn.Linear(d, hidden)
        self.linear2 = nn.Linear(hidden, d)
        self.norm1 = nn.LayerNorm(d)
        self.norm2 = nn.LayerNorm(d)
        self.norm3 = nn.LayerNorm(d)
        self.norm_out = GroupNormSeq(d)
        self.gamma_1 = LayerScale(d, channel_last=True)
        self.gamma_2 = LayerScale(d, channel_last=True)

    def forward(self, q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
        kn = self.norm2(k)
        x = q + self.gamma_1(self.cross_attn(self.norm1(q), kn, kn))
        x = x + self.gamma_2(self.linear2(F.gelu(self.linear1(self.norm3(x)))))
        return self.norm_out(x)


class CrossTransformerEncoder(nn.Module):
    def __init__(self, d: int, layers: int, heads: int, hidden: int):
        super().__init__()
        self.norm_in = nn.LayerNorm(d)
        self.norm_in_t = nn.LayerNorm(d)
        self.layers = nn.ModuleList()
        self.layers_t = nn.ModuleList()
        for i in range(layers):
            layer = SelfAttentionLayer if i % 2 == 0 else CrossAttentionLayer
            self.layers.append(layer(d, heads, hidden))
            self.layers_t.append(layer(d, heads, hidden))

    def forward(self, x: torch.Tensor, xt: torch.Tensor):
        b, c, fr, t1 = x.shape
        pos2d = create_2d_sin_embedding(c, fr, t1, x.device)
        pos2d = pos2d.permute(0, 3, 2, 1).reshape(1, t1 * fr, c)   # b (t1 fr) c
        x = self.norm_in(x.permute(0, 3, 2, 1).reshape(b, t1 * fr, c)) + pos2d
        t2 = xt.shape[-1]
        pos = create_sin_embedding(t2, c, x.device).permute(1, 0, 2)   # 1 t2 c
        xt = self.norm_in_t(xt.transpose(1, 2)) + pos
        for i, (layer, layer_t) in enumerate(zip(self.layers, self.layers_t)):
            if i % 2 == 0:
                x, xt = layer(x), layer_t(xt)
            else:
                x, xt = layer(x, xt), layer_t(xt, x)
        x = x.reshape(b, t1, fr, c).permute(0, 3, 2, 1)
        return x, xt.transpose(1, 2)


class ScaledEmbedding(nn.Module):
    """demucs' ``ScaledEmbedding``: the table times ``scale``."""

    def __init__(self, n: int, dim: int, scale: float = 10.0):
        super().__init__()
        self.embedding = nn.Embedding(n, dim)
        self.scale = scale

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embedding(idx) * self.scale


class HTDemucs(nn.Module):
    """``forward(mix [B, AC, T]) -> [B, S, AC, T]``; the constructor takes
    the port's ``HTDemucsRef`` keywords (a configuration's ``net`` block)."""

    def __init__(self, sources=("music", "effect", "dialog"), audio_channels: int = 2,
                 channels: int = 48, growth: int = 2, depth: int = 4, nfft: int = 4096,
                 kernel_size: int = 8, stride: int = 4, context: int = 1,
                 context_enc: int = 0, bottom_channels: int = 512, t_layers: int = 5,
                 t_heads: int = 8, t_hidden_scale: float = 4.0, dconv_depth: int = 2,
                 dconv_comp: int = 8, freq_emb_scale: float = 0.2,
                 samplerate: int = 44100, segment: float = 10.0):
        super().__init__()
        disable_tf32()
        self.sources = tuple(sources)
        self.audio_channels = audio_channels
        self.nfft, self.hop = nfft, nfft // 4
        self.depth = depth
        self.bottom_channels = bottom_channels
        self.freq_emb_scale = freq_emb_scale
        self.samplerate, self.segment = samplerate, segment
        n_src = len(self.sources)
        enc_kw = dict(kernel=kernel_size, stride=stride, context_enc=context_enc,
                      dconv_depth=dconv_depth, dconv_comp=dconv_comp)
        dec_kw = dict(kernel=kernel_size, stride=stride, context=context)
        self.encoder, self.tencoder = nn.ModuleList(), nn.ModuleList()
        self.decoder, self.tdecoder = nn.ModuleList(), nn.ModuleList()
        chin, chin_z, chout = audio_channels, audio_channels * 2, channels
        for index in range(depth):
            self.encoder.append(HEncLayer(chin_z, chout, True, **enc_kw))
            self.tencoder.append(HEncLayer(chin, chout, False, **enc_kw))
            if index == 0:
                chin, chin_z = audio_channels * n_src, audio_channels * 2 * n_src
            self.decoder.insert(0, HDecLayer(chout, chin_z, True, index == 0, **dec_kw))
            self.tdecoder.insert(0, HDecLayer(chout, chin, False, index == 0, **dec_kw))
            chin = chin_z = chout
            chout = int(growth * chout)
        self.freq_emb = ScaledEmbedding(nfft // 2 // stride, channels)
        transformer_c = channels * growth ** (depth - 1)
        if bottom_channels:
            self.channel_upsampler = nn.Conv1d(transformer_c, bottom_channels, 1)
            self.channel_downsampler = nn.Conv1d(bottom_channels, transformer_c, 1)
            self.channel_upsampler_t = nn.Conv1d(transformer_c, bottom_channels, 1)
            self.channel_downsampler_t = nn.Conv1d(bottom_channels, transformer_c, 1)
            transformer_c = bottom_channels
        self.crosstransformer = CrossTransformerEncoder(
            transformer_c, t_layers, t_heads, int(t_hidden_scale * transformer_c))

    def _spec(self, x: torch.Tensor) -> torch.Tensor:
        hl, nfft = self.hop, self.nfft
        le = int(math.ceil(x.shape[-1] / hl))
        pad = hl // 2 * 3
        x = F.pad(x, (pad, pad + le * hl - x.shape[-1]), mode="reflect")
        lead = x.shape[:-1]
        z = torch.stft(x.reshape(-1, x.shape[-1]), nfft, hl,
                       window=torch.hann_window(nfft, device=x.device), win_length=nfft,
                       normalized=True, center=True, return_complex=True, pad_mode="reflect")
        z = z.view(*lead, *z.shape[-2:])[..., :-1, :]
        return z[..., 2:2 + le]

    def _ispec(self, z: torch.Tensor, length: int) -> torch.Tensor:
        hl = self.hop
        z = torch.cat([torch.complex(z[..., :1, :].real, torch.zeros_like(z[..., :1, :].real)),
                       z[..., 1:, :]], dim=-2)
        z = F.pad(z, (0, 0, 0, 1))
        z = F.pad(z, (2, 2))
        pad = hl // 2 * 3
        le = hl * int(math.ceil(length / hl)) + 2 * pad
        lead = z.shape[:-2]
        x = torch.istft(z.reshape(-1, *z.shape[-2:]), self.nfft, hl,
                        window=torch.hann_window(self.nfft, device=z.device),
                        win_length=self.nfft, normalized=True, length=le, center=True)
        return x.view(*lead, le)[..., pad:pad + length]

    def forward(self, mix: torch.Tensor) -> torch.Tensor:
        length = mix.shape[-1]
        z = self._spec(mix)
        b, c, fq, t = z.shape
        x = torch.view_as_real(z).permute(0, 1, 4, 2, 3).reshape(b, c * 2, fq, t)
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        std = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = (x - mean) / (1e-5 + std)
        meant = mix.mean(dim=(1, 2), keepdim=True)
        stdt = mix.std(dim=(1, 2), keepdim=True, correction=0)
        xt = (mix - meant) / (1e-5 + stdt)

        saved, saved_t, lengths_t = [], [], []
        for idx in range(self.depth):
            lengths_t.append(xt.shape[-1])
            xt = self.tencoder[idx](xt)
            saved_t.append(xt)
            x = self.encoder[idx](x)
            if idx == 0:
                frs = torch.arange(x.shape[-2], device=x.device)
                emb = self.freq_emb(frs).t()[None, :, :, None].expand_as(x)
                x = x + self.freq_emb_scale * emb
            saved.append(x)

        if self.bottom_channels:
            bb, cc, f, tt = x.shape
            x = self.channel_upsampler(x.reshape(bb, cc, f * tt)).reshape(bb, -1, f, tt)
            xt = self.channel_upsampler_t(xt)
        x, xt = self.crosstransformer(x, xt)
        if self.bottom_channels:
            bb, cc, f, tt = x.shape
            x = self.channel_downsampler(x.reshape(bb, cc, f * tt)).reshape(bb, -1, f, tt)
            xt = self.channel_downsampler_t(xt)

        for idx in range(self.depth):
            x = self.decoder[idx](x, saved.pop(-1), 0)
            xt = self.tdecoder[idx](xt, saved_t.pop(-1), lengths_t.pop(-1))

        n_src = len(self.sources)
        x = x.view(b, n_src, -1, fq, t) * std[:, None] + mean[:, None]
        x = x.view(b, n_src, -1, 2, fq, t).permute(0, 1, 2, 4, 5, 3)
        x = self._ispec(torch.view_as_complex(x.contiguous()), length)
        xt = xt.view(b, n_src, -1, length) * stdt[:, None] + meant[:, None]
        return xt + x

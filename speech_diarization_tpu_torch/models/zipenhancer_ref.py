"""The published ZipEnhancer graph as an ``nn.Module``: the JAX package's
``models/zipenhancer_ref.py``.

"ZipEnhancer: Dual-Path Down-Up Sampling-based Zipformer for Monaural Speech
Enhancement" (Wang et al., ICASSP 2025), the architecture of the ModelScope
``iic/speech_zipenhancer_ans_multiloss_16k_base`` bundle: an MP-SENet dense
encoder, TS blocks that run a downsampled Zipformer2 encoder along time and
then along frequency, and the MP-SENet mask and phase decoders.  The module
tree reproduces the bundle's ``state_dict`` names (``dense_encoder.
dense_conv_1.0.weight``, ``ts_blocks.0.time.encoder.layers.0.
self_attn_weights.in_proj.weight`` ...), which are the keys of the JAX
parameter dict, so a JAX draw and a ModelScope state_dict both load with a
strict ``load_state_dict`` (``models/port_zipenhancer.py``).

Inference graph only: the bundle's balancers, whiteners and dropouts are
identities at inference and hold no parameters.  JAX semantics kept where
torch's zipformer differs: the attention scores are ``q . k`` (no
``1/sqrt(d)``: the scale is folded into ``in_proj``) plus the relative
position scores, and the relative shift is the JAX package's gather (the
``[T, T]`` table of offsets ``t - s``), not icefall's ``as_strided`` trick.
The gather is applied to the position projections before the product with
the queries, which gives the same scores without the ``[N, H, S, 2S-1]``
tensor (5.4 GB a 64-window batch on the time path).  Instance norms use the
population variance, PReLU is ``where(x >= 0, x, a * x)``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..dsp.stft import istft_ri, stft_ri


# ---------------------------------------------------------------------------
# zipformer primitives
# ---------------------------------------------------------------------------

# ``F.softplus`` is ``logaddexp(0, x)``; above its threshold of 20 it
# returns x, which differs by log1p(exp(-20)) = 2e-9, under float32's step
def swoosh_l(x: torch.Tensor) -> torch.Tensor:
    """SwooshL(x) = log(1 + exp(x - 4)) - 0.08x - 0.035."""
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x: torch.Tensor) -> torch.Tensor:
    """SwooshR(x) = log(1 + exp(x - 1)) - 0.08x - 0.313261687."""
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


_PE: dict = {}


def compact_rel_pos_encoding(seq_len: int, pos_dim: int, device=None,
                             length_factor: float = 1.0) -> torch.Tensor:
    """CompactRelPositionalEncoding: ``[2*seq_len - 1, pos_dim]`` over the
    relative offsets -(T-1)..(T-1), log-compressed then atan-squashed;
    made once per shape and device."""
    key = (seq_len, pos_dim, length_factor, str(device))
    if key not in _PE:
        x = torch.arange(-(seq_len - 1), seq_len, dtype=torch.float32)[:, None]
        compression = float(np.sqrt(pos_dim))
        x_c = compression * torch.sign(x) * (
            torch.log(torch.abs(x) + compression) - float(np.log(compression)))
        x_atan = torch.atan(x_c / (length_factor * float(np.sqrt(pos_dim))))
        freqs = torch.arange(1, pos_dim // 2 + 1, dtype=torch.float32)
        pe = torch.zeros((x.shape[0], pos_dim), dtype=torch.float32)
        pe[:, 0::2] = torch.cos(x_atan * freqs)
        pe[:, 1::2] = torch.sin(x_atan * freqs)
        pe[:, -1] = 1.0
        _PE[key] = pe.to(device)
    return _PE[key]


def rel_pos_scores(pq: torch.Tensor, pp: torch.Tensor) -> torch.Tensor:
    """The JAX ``rel_shift(einsum('nshd,rhd->nhsr', pq, pp), S)``: query
    position projections ``pq [N, S, H, d]`` against the offset table ``pp
    [2S-1, H, d]``, score ``[n, h, s, t]`` read at offset ``t - s``.  The
    table is gathered first (``[S, S, H, d]``), so no ``[N, H, S, 2S-1]``
    tensor is formed."""
    s = pq.shape[1]
    idx = (torch.arange(s, device=pq.device)[None, :]
           - torch.arange(s, device=pq.device)[:, None]) + (s - 1)   # [S, S]
    return torch.einsum("nshd,sthd->nhst", pq, pp[idx])


class BiasNorm(nn.Module):
    """``x * exp(log_scale) / rms(x - bias)`` over the channel dim."""

    def __init__(self, c: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        self.log_scale = nn.Parameter(torch.zeros(()), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rms = torch.sqrt(torch.mean((x - self.bias) ** 2, dim=-1, keepdim=True)
                         + 1e-12)
        return x * (torch.exp(self.log_scale) / rms)


class Bypass(nn.Module):
    """``src_orig + (src - src_orig) * clip(bypass_scale, 0, 1)``."""

    def __init__(self, c: int):
        super().__init__()
        self.bypass_scale = nn.Parameter(torch.full((c,), 0.5), requires_grad=False)

    def forward(self, src_orig: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
        return src_orig + (src - src_orig) * torch.clamp(self.bypass_scale, 0.0, 1.0)


class RelPositionAttentionWeights(nn.Module):
    """RelPositionMultiheadAttentionWeights: [N, S, C] -> softmax scores
    [N, H, S, S]."""

    def __init__(self, c: int, heads: int, query_head_dim: int,
                 pos_head_dim: int, pos_dim: int):
        super().__init__()
        self.heads, self.qhd, self.phd = heads, query_head_dim, pos_head_dim
        self.in_proj = nn.Linear(c, 2 * heads * query_head_dim + heads * pos_head_dim)
        self.linear_pos = nn.Linear(pos_dim, heads * pos_head_dim, bias=False)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor) -> torch.Tensor:
        n, s, _ = x.shape
        h, qd = self.heads, self.heads * self.qhd
        proj = self.in_proj(x)
        q = proj[..., :qd].reshape(n, s, h, self.qhd).transpose(1, 2)
        k = proj[..., qd:2 * qd].reshape(n, s, h, self.qhd).transpose(1, 2)
        pq = proj[..., 2 * qd:].reshape(n, s, h, self.phd)
        pp = self.linear_pos(pos_emb).reshape(pos_emb.shape[0], h, self.phd)
        attn = q @ k.transpose(-1, -2)                          # [N, H, S, S]
        attn += rel_pos_scores(pq, pp)
        return torch.softmax(attn, dim=-1)


class SelfAttention(nn.Module):
    """Value projection mixed by externally computed attention weights."""

    def __init__(self, c: int, heads: int, value_head_dim: int):
        super().__init__()
        self.heads, self.vhd = heads, value_head_dim
        self.in_proj = nn.Linear(c, heads * value_head_dim)
        self.out_proj = nn.Linear(heads * value_head_dim, c)

    def forward(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        n, s, _ = x.shape
        v = self.in_proj(x).reshape(n, s, self.heads, self.vhd).transpose(1, 2)
        out = (attn @ v).transpose(1, 2).reshape(n, s, self.heads * self.vhd)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.in_proj = nn.Linear(c, hidden)
        self.out_proj = nn.Linear(hidden, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(swoosh_l(self.in_proj(x)))


class NonlinAttention(nn.Module):
    """tanh-gated value mixed by the first attention head, output-gated by
    the third projection chunk."""

    def __init__(self, c: int, hidden: int):
        super().__init__()
        self.in_proj = nn.Linear(c, 3 * hidden)
        self.out_proj = nn.Linear(hidden, c)

    def forward(self, x: torch.Tensor, attn_head0: torch.Tensor) -> torch.Tensor:
        sg, v, y = self.in_proj(x).chunk(3, dim=-1)
        v = attn_head0 @ (v * torch.tanh(sg))                  # [N, S, hidden]
        return self.out_proj(v * y)


class ConvolutionModule(nn.Module):
    """Sigmoid-gated bottleneck -> depthwise conv over the sequence ->
    SwooshR -> out_proj (non-causal)."""

    def __init__(self, c: int, kernel: int):
        super().__init__()
        self.in_proj = nn.Linear(c, 2 * c)
        self.depthwise_conv = nn.Conv1d(c, c, kernel, padding=kernel // 2, groups=c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v, g = self.in_proj(x).chunk(2, dim=-1)
        v = self.depthwise_conv((v * torch.sigmoid(g)).transpose(1, 2))
        return self.out_proj(swoosh_r(v.transpose(1, 2)))


class Zipformer2Layer(nn.Module):
    """One Zipformer2EncoderLayer in icefall's inference order."""

    def __init__(self, c: int, heads: int, query_head_dim: int, pos_head_dim: int,
                 value_head_dim: int, pos_dim: int, feedforward_dim: int,
                 conv_kernel: int):
        super().__init__()
        ff = feedforward_dim
        self.self_attn_weights = RelPositionAttentionWeights(
            c, heads, query_head_dim, pos_head_dim, pos_dim)
        self.self_attn1 = SelfAttention(c, heads, value_head_dim)
        self.self_attn2 = SelfAttention(c, heads, value_head_dim)
        self.feed_forward1 = FeedForward(c, (ff * 3) // 4)
        self.feed_forward2 = FeedForward(c, ff)
        self.feed_forward3 = FeedForward(c, (ff * 5) // 4)
        self.nonlin_attention = NonlinAttention(c, (3 * c) // 4)
        self.conv_module1 = ConvolutionModule(c, conv_kernel)
        self.conv_module2 = ConvolutionModule(c, conv_kernel)
        self.norm = BiasNorm(c)
        self.bypass = Bypass(c)
        self.bypass_mid = Bypass(c)

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor) -> torch.Tensor:
        src_orig = x
        attn = self.self_attn_weights(x, pos_emb)
        x = x + self.feed_forward1(x)
        x = x + self.nonlin_attention(x, attn[:, 0])
        x = x + self.self_attn1(x, attn)
        x = x + self.conv_module1(x)
        x = x + self.feed_forward2(x)
        x = self.bypass_mid(src_orig, x)
        x = x + self.self_attn2(x, attn)
        x = x + self.conv_module2(x)
        x = x + self.feed_forward3(x)
        return self.bypass(src_orig, self.norm(x))


class SimpleDownsample(nn.Module):
    """Softmax-weighted mean of every ``ds`` frames (the last frame repeats
    to a whole multiple)."""

    def __init__(self, ds: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(ds), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, c = x.shape
        ds = self.bias.shape[0]
        s_pad = -(-s // ds) * ds
        if s_pad != s:
            x = torch.cat([x, x[:, -1:].expand(n, s_pad - s, c)], dim=1)
        w = torch.softmax(self.bias, dim=0)
        return (x.reshape(n, s_pad // ds, ds, c) * w[None, None, :, None]).sum(2)


class DownsampledZipformer2Encoder(nn.Module):
    """Downsample by ``ds`` -> Zipformer2 layers -> repeat-upsample ->
    bypass-combine, over [N, S, C]."""

    def __init__(self, c: int, num_layers: int, downsample: int, pos_dim: int,
                 **layer_kw):
        super().__init__()
        self.ds, self.pos_dim = downsample, pos_dim
        self.downsample = SimpleDownsample(downsample)
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList(
            [Zipformer2Layer(c, pos_dim=pos_dim, **layer_kw) for _ in range(num_layers)])
        self.out_combiner = Bypass(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        src_orig = x
        s = x.shape[1]
        if self.ds > 1:
            x = self.downsample(x)
        pos_emb = compact_rel_pos_encoding(x.shape[1], self.pos_dim, x.device)
        for layer in self.encoder.layers:
            x = layer(x, pos_emb)
        if self.ds > 1:
            x = torch.repeat_interleave(x, self.ds, dim=1)[:, :s]
        return self.out_combiner(src_orig, x)


class TSBlock(nn.Module):
    def __init__(self, c: int, **kw):
        super().__init__()
        self.time = DownsampledZipformer2Encoder(c, **kw)
        self.freq = DownsampledZipformer2Encoder(c, **kw)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """h [B, C, T, F]: sequences over T batched across B*F, then
        sequences over F batched across B*T."""
        b, c, t, f = h.shape
        ht = self.time(h.permute(0, 3, 2, 1).reshape(b * f, t, c))
        h = ht.reshape(b, f, t, c).permute(0, 3, 2, 1)
        hf = self.freq(h.permute(0, 2, 3, 1).reshape(b * t, f, c))
        return hf.reshape(b, t, f, c).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# MP-SENet front and back ends
# ---------------------------------------------------------------------------

class InstanceNorm2d(nn.Module):
    """InstanceNorm2d(affine=True): per sample and channel over (T, F),
    population variance, eps 1e-5."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self.eps)


class PReLU(nn.Module):
    """Channel-wise PReLU over [B, C, T, F]: ``where(x >= 0, x, a * x)``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((c,), 0.25), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight[None, :, None, None] * x)


class DenseBlock(nn.Module):
    """Dilated (time-causal) 3x3 convs with dense channel concatenation:
    ``dense_conv_{i}`` = (pad, conv, instance norm, PReLU)."""

    def __init__(self, c: int, depth: int = 4):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            dil = 2 ** i
            self.add_module(f"dense_conv_{i + 1}", nn.Sequential(
                nn.ConstantPad2d((1, 1, 2 * dil, 0), 0.0),
                nn.Conv2d(c * (i + 1), c, (3, 3), dilation=(dil, 1)),
                InstanceNorm2d(c), PReLU(c)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skip = x
        for i in range(self.depth):
            x = getattr(self, f"dense_conv_{i + 1}")(skip)
            skip = torch.cat([x, skip], dim=1)
        return x


class SPConvTranspose2d(nn.Module):
    """Freq pad (1, 1) -> conv (1, 3) with r*C outputs -> the r groups
    interleaved along frequency (sub-pixel upsample)."""

    def __init__(self, c_in: int, c_out: int, r: int = 2):
        super().__init__()
        self.r = r
        self.conv = nn.Conv2d(c_in, c_out * r, (1, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(F.pad(x, (1, 1)))
        b, rc, t, f = h.shape
        c = rc // self.r
        return h.reshape(b, self.r, c, t, f).permute(0, 2, 3, 4, 1).reshape(
            b, c, t, f * self.r)


class DenseEncoder(nn.Module):
    """[B, 2, T, n_bins] -> [B, C, T, n_bins // 2 + 1]."""

    def __init__(self, c: int):
        super().__init__()
        self.dense_conv_1 = nn.Sequential(nn.Conv2d(2, c, (1, 1)),
                                          InstanceNorm2d(c), PReLU(c))
        self.dense_block = DenseBlock(c)
        self.dense_conv_2 = nn.Sequential(
            nn.Conv2d(c, c, (1, 3), stride=(1, 2), padding=(0, 1)),
            InstanceNorm2d(c), PReLU(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.dense_conv_2(self.dense_block(self.dense_conv_1(x)))


class LearnableSigmoid2d(nn.Module):
    def __init__(self, n_bins: int, beta: float = 2.0):
        super().__init__()
        self.beta = beta
        self.slope = nn.Parameter(torch.ones(n_bins, 1), requires_grad=False)

    def forward(self, m: torch.Tensor) -> torch.Tensor:
        return self.beta * torch.sigmoid(self.slope[None, None, :, 0] * m)


class MaskDecoder(nn.Module):
    """[B, C, T, F'] -> magnitude mask [B, T, n_bins] in (0, beta)."""

    def __init__(self, c: int, n_bins: int, beta: float):
        super().__init__()
        self.dense_block = DenseBlock(c)
        self.mask_conv = nn.Sequential(SPConvTranspose2d(c, c, 2), InstanceNorm2d(c),
                                       PReLU(c), nn.Conv2d(c, 1, (1, 2)))
        self.lsigmoid = LearnableSigmoid2d(n_bins, beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lsigmoid(self.mask_conv(self.dense_block(x))[:, 0])


class PhaseDecoder(nn.Module):
    """[B, C, T, F'] -> phase [B, T, n_bins] as ``atan2`` of two heads."""

    def __init__(self, c: int):
        super().__init__()
        self.dense_block = DenseBlock(c)
        self.phase_conv = nn.Sequential(SPConvTranspose2d(c, c, 2),
                                        InstanceNorm2d(c), PReLU(c))
        self.phase_conv_r = nn.Conv2d(c, 1, (1, 2))
        self.phase_conv_i = nn.Conv2d(c, 1, (1, 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.phase_conv(self.dense_block(x))
        return torch.atan2(self.phase_conv_i(h)[:, 0], self.phase_conv_r(h)[:, 0])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def exact_zero_imag(im: torch.Tensor, n_fft: int) -> torch.Tensor:
    """``im [B, F, T]`` with +0 where the imaginary part is zero in exact
    arithmetic: the DC bin, the Nyquist bin (even ``n_fft``) and the first
    frame, which the reflect-centred STFT makes symmetric about its middle.
    Computed, those entries are rounding noise whose sign depends on the
    summation order, and ``atan2`` turns the sign into a phase of +pi or -pi
    wherever the real part is negative: the JAX graph's input phase there
    differs between two backends, and so does its output (ROADMAP F18).
    With +0 the phase is 0 or +pi on every device."""
    keep = torch.ones(im.shape[-2:], dtype=torch.bool, device=im.device)
    keep[0] = False
    if n_fft % 2 == 0:
        keep[-1] = False
    keep[:, 0] = False
    return torch.where(keep, im, 0.0)

class ZipEnhancerRef(nn.Module):
    """Noisy wav [B, L] -> enhanced wav [B, L] at 16 kHz (the ModelScope
    ``model(dict(noisy=...))['wav_l2']`` contract).  The constructor's
    arguments and defaults are the JAX class's: the published base
    configuration (dense channel 64, 4 TS blocks of 2 Zipformer2 layers a
    path, downsample 2)."""

    def __init__(self, n_fft: int = 400, hop: int = 100, dense_channel: int = 64,
                 num_tsblocks: int = 4, num_layers: int = 2, downsample: int = 2,
                 heads: int = 4, query_head_dim: int = 32, pos_head_dim: int = 4,
                 value_head_dim: int = 12, pos_dim: int = 48,
                 feedforward_dim: int = 192, conv_kernel: int = 15,
                 compress: float = 0.3, beta: float = 2.0, sample_rate: int = 16000):
        super().__init__()
        self.n_fft, self.hop = n_fft, hop
        self.compress, self.beta = compress, beta
        self.sample_rate = sample_rate
        self.n_bins = n_fft // 2 + 1
        c = dense_channel
        self.dense_encoder = DenseEncoder(c)
        self.ts_blocks = nn.ModuleList([TSBlock(
            c, num_layers=num_layers, downsample=downsample, pos_dim=pos_dim,
            heads=heads, query_head_dim=query_head_dim, pos_head_dim=pos_head_dim,
            value_head_dim=value_head_dim, feedforward_dim=feedforward_dim,
            conv_kernel=conv_kernel) for _ in range(num_tsblocks)])
        self.mask_decoder = MaskDecoder(c, self.n_bins, beta)
        self.phase_decoder = PhaseDecoder(c)

    def manifest(self) -> dict[str, tuple[int, ...]]:
        """state_dict key -> shape (the checkpoint contract)."""
        return {k: tuple(v.shape) for k, v in self.state_dict().items()}

    def param_count(self, p: dict | None = None) -> int:
        """Weights in the state dict ``p`` (arrays or tensors), or in the
        module's own state dict when ``p`` is None."""
        p = self.state_dict() if p is None else p
        return int(sum(np.prod(tuple(v.shape)) for v in p.values()))

    def apply_spec(self, mag: torch.Tensor, pha: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Compressed magnitude and phase [B, T, F] -> (denoised magnitude,
        phase); ``mag`` is already ``mag ** compress``."""
        h = self.dense_encoder(torch.stack([mag, pha], dim=1))   # [B, C, T, F']
        for blk in self.ts_blocks:
            h = blk(h)
        return mag * self.mask_decoder(h), self.phase_decoder(h)

    def forward(self, wavs: torch.Tensor) -> torch.Tensor:
        spec = stft_ri(wavs, self.n_fft, self.hop)              # [B, F, T, 2]
        re, im = spec[..., 0], exact_zero_imag(spec[..., 1], self.n_fft)
        mag = torch.sqrt(re * re + im * im + 1e-9)
        pha = torch.atan2(im, re)
        mag_d, pha_d = self.apply_spec(
            torch.pow(mag, self.compress).transpose(1, 2), pha.transpose(1, 2))
        mag_out = torch.pow(torch.clamp(mag_d, min=1e-9),
                            1.0 / self.compress).transpose(1, 2)    # [B, F, T]
        pha_out = pha_d.transpose(1, 2)
        spec_out = torch.stack([mag_out * torch.cos(pha_out),
                                mag_out * torch.sin(pha_out)], dim=-1)
        return istft_ri(spec_out, self.n_fft, self.hop, length=wavs.shape[-1])

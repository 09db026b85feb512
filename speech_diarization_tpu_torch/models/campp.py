"""CAM++ speaker embedder (3D-Speaker CAMPPlus) as an ``nn.Module``.

The JAX package's ``models/campp.py`` in PyTorch: the same graph (float32
throughout), submodules named so that ``state_dict()`` keys equal the JAX
``manifest()`` keys, the torch names of the 3D-Speaker module.

Architecture (growth 32, bottleneck 128, init 128, blocks 12/24/16 at
dilations 1/2/2, 192-d):
  head  = FCM: conv/bn stem, two residual stages that stride 2 in
          frequency, one more frequency-stride conv -> [B, 32 * F/8, T]
  xvector.tdnn       = k5 stride-2 conv over time + BN-ReLU
  xvector.block{1-3} = dense layers: BN-ReLU -> 1x1 bottleneck -> BN-ReLU
          -> CAM layer (a local conv gated by a sigmoid MLP over the global
          mean + the 100-frame segment means), concatenated onto the input
  xvector.transit{1-3} = BN-ReLU -> 1x1 conv halving the channels
  xvector.out_nonlinear = BN-ReLU
  stats pooling      = mean ++ unbiased std over time
  xvector.dense      = 1x1 linear -> BatchNorm without affine

The log-mel of :meth:`CamPlusPlusModel.encode_batch` is one launch of
kernel K2; the rest is convolutions, BatchNorm and pointwise ops.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm
from .port import load_torch_layout


class _BNReLU(nn.Module):
    """``nonlinear.batchnorm`` (+ ReLU unless ``relu`` is False)."""

    def __init__(self, c: int, relu: bool = True, affine: bool = True):
        super().__init__()
        self.batchnorm = BatchNorm(c, affine=affine)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.batchnorm(x)
        return F.relu(x) if self.relu else x


class _ResBlock(nn.Module):
    """The FCM head's residual block; ``stride`` strides frequency."""

    def __init__(self, m: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(m, m, 3, stride=(stride, 1), padding=1, bias=False)
        self.bn1 = BatchNorm(m)
        self.conv2 = nn.Conv2d(m, m, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(m)
        self.shortcut = nn.Sequential()
        if stride != 1:
            self.shortcut = nn.Sequential(
                nn.Conv2d(m, m, 1, stride=(stride, 1), bias=False), BatchNorm(m))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + self.shortcut(x))


class FCM(nn.Module):
    """[B, 1, F, T] -> [B, m * F/8, T]."""

    def __init__(self, m: int):
        super().__init__()
        self.conv1 = nn.Conv2d(1, m, 3, padding=1, bias=False)
        self.bn1 = BatchNorm(m)
        self.layer1 = nn.Sequential(_ResBlock(m, 2), _ResBlock(m, 1))
        self.layer2 = nn.Sequential(_ResBlock(m, 2), _ResBlock(m, 1))
        self.conv2 = nn.Conv2d(m, m, 3, stride=(2, 1), padding=1, bias=False)
        self.bn2 = BatchNorm(m)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer2(self.layer1(x))
        x = F.relu(self.bn2(self.conv2(x)))
        b, c, f, t = x.shape
        return x.reshape(b, c * f, t)


class _TDNN(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.linear = nn.Conv1d(c_in, c_out, 5, stride=2, padding=2)
        self.nonlinear = _BNReLU(c_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.nonlinear(self.linear(x))


def segment_means(x: torch.Tensor, seg_len: int) -> torch.Tensor:
    """Each ``seg_len``-frame segment's mean broadcast back over its frames
    (the ragged tail averaged over its true length): [B, C, T] -> same."""
    t = x.shape[-1]
    seg = F.avg_pool1d(x, seg_len, seg_len, ceil_mode=True)     # [B, C, n_seg]
    return seg.repeat_interleave(seg_len, dim=2)[..., :t]


class _CAMLayer(nn.Module):
    def __init__(self, c: int, growth: int, k: int, dilation: int, seg_len: int):
        super().__init__()
        self.linear_local = nn.Conv1d(c, growth, k, padding=(k - 1) // 2 * dilation,
                                      dilation=dilation, bias=False)
        self.linear1 = nn.Conv1d(c, c // 2, 1)
        self.linear2 = nn.Conv1d(c // 2, growth, 1)
        self.seg_len = seg_len

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.linear_local(x)
        context = x.mean(dim=2, keepdim=True) + segment_means(x, self.seg_len)
        m = torch.sigmoid(self.linear2(F.relu(self.linear1(context))))
        return y * m


class _DenseLayer(nn.Module):
    """One ``tdnnd``: its output is concatenated onto its input."""

    def __init__(self, c_in: int, bn_c: int, growth: int, k: int, dilation: int,
                 seg_len: int):
        super().__init__()
        self.nonlinear1 = _BNReLU(c_in)
        self.linear1 = nn.Conv1d(c_in, bn_c, 1, bias=False)
        self.nonlinear2 = _BNReLU(bn_c)
        self.cam_layer = _CAMLayer(bn_c, growth, k, dilation, seg_len)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.nonlinear2(self.linear1(self.nonlinear1(x)))
        return torch.cat([x, self.cam_layer(h)], dim=1)


class _Transit(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.nonlinear = _BNReLU(c_in)
        self.linear = nn.Conv1d(c_in, c_out, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.nonlinear(x))


class _Dense(nn.Module):
    def __init__(self, c_in: int, emb_dim: int):
        super().__init__()
        self.linear = nn.Conv1d(c_in, emb_dim, 1, bias=False)
        self.nonlinear = _BNReLU(emb_dim, relu=False, affine=False)

    def forward(self, stats: torch.Tensor) -> torch.Tensor:
        return self.nonlinear(self.linear(stats[:, :, None]))[:, :, 0]


class CamPlusPlus(nn.Module):
    """fbank [B, T, n_mels] -> [B, emb_dim] float32."""

    def __init__(self, n_mels: int = 80, m_channels: int = 32,
                 init_channels: int = 128, growth: int = 32,
                 bn_channels: int = 128, num_layers: tuple[int, ...] = (12, 24, 16),
                 dilations: tuple[int, ...] = (1, 2, 2),
                 kernels: tuple[int, ...] = (3, 3, 3), emb_dim: int = 192,
                 seg_len: int = 100):
        super().__init__()
        self.n_mels = n_mels
        self.emb_dim = emb_dim
        self.head = FCM(m_channels)
        xv = nn.Module()
        xv.add_module("tdnn", _TDNN(m_channels * (n_mels // 8), init_channels))
        c = init_channels
        for bi, (n, k, d) in enumerate(zip(num_layers, kernels, dilations)):
            block = nn.Sequential()
            for li in range(n):
                block.add_module(f"tdnnd{li + 1}", _DenseLayer(
                    c + li * growth, bn_channels, growth, k, d, seg_len))
            xv.add_module(f"block{bi + 1}", block)
            c += n * growth
            xv.add_module(f"transit{bi + 1}", _Transit(c, c // 2))
            c //= 2
        xv.add_module("out_nonlinear", _BNReLU(c))
        xv.add_module("dense", _Dense(2 * c, emb_dim))
        self.xvector = xv
        self.n_blocks = len(num_layers)

    def manifest(self) -> dict[str, tuple[int, ...]]:
        """state_dict key -> shape (the checkpoint contract)."""
        return {k: tuple(v.shape) for k, v in self.state_dict().items()}

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        xv = self.xvector
        x = self.head(feats.transpose(1, 2)[:, None].float())
        x = xv.tdnn(x)
        for bi in range(1, self.n_blocks + 1):
            x = getattr(xv, f"transit{bi}")(getattr(xv, f"block{bi}")(x))
        x = xv.out_nonlinear(x)
        # mean ++ std over time, the unbiased variance as the JAX package
        # forms it (no NaN at one frame)
        t = x.shape[2]
        var = x.var(dim=2, correction=0) * (t / max(t - 1, 1))
        stats = torch.cat([x.mean(dim=2), torch.sqrt(var)], dim=1)
        return xv.dense(stats).float()


class CamPlusPlusModel(nn.Module):
    """Waveform wrapper: ``encode_batch`` [B, T] -> [B, emb_dim]."""

    def __init__(self, net: CamPlusPlus | None = None, sample_rate: int = 16000):
        super().__init__()
        self.net = net or CamPlusPlus()
        self.sample_rate = sample_rate

    def encode_batch(self, wavs: torch.Tensor) -> torch.Tensor:
        """:func:`~..dsp.mel.fbank_batch` at the net's mels with per-window
        mean-norm (one K2 launch on the card), then the net."""
        from ..dsp.mel import fbank_batch

        return self.net(fbank_batch(wavs, sample_rate=self.sample_rate,
                                    n_mels=self.net.n_mels))


def load_campp(src, net: CamPlusPlus | None = None,
               strict: bool = True) -> CamPlusPlus:
    """A 3D-Speaker CAMPPlus checkpoint into ``net`` (default: the published
    widths): a mapping, a ``.onnx`` path or a torch checkpoint path, as
    :func:`~.eres2netv2.load_eres2netv2` takes them; ``strict`` checks the
    keys and shapes against the manifest."""
    return load_torch_layout(net or CamPlusPlus(), src, strict)

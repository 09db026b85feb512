"""ERes2NetV2 speaker embedder (3D-Speaker, w24s4ep4) as an ``nn.Module``.

The JAX package's ``models/eres2netv2.py`` in PyTorch: the same graph and
cast points (float32 throughout), submodules named so that ``state_dict()``
keys equal the JAX ``manifest()`` keys, which are the torch names of the
3D-Speaker module.  A JAX parameter dict converted to numpy, a 3D-Speaker
torch checkpoint and the initializers of its ONNX export all load through
``load_state_dict`` (:func:`load_eres2netv2`).

Architecture (baseWidth 24, scale 4, expansion 4, m_channels 32):
  conv1/bn1 stem on the [B, 1, F, T] fbank image
  layer1/2: Res2-style blocks (group i adds the running feature)
  layer3/4: the same with the running feature AFF-fused into group i
  layer3_ds: stride-2 3x3 conv taking layer3 to layer4's grid
  fuse34: AFF(out4, out3_ds)
  TSTP pooling (mean ++ std over time of [B, C*F, T]) -> seg_1 Linear

AFF gate: att = 1 + tanh(BN(conv(SiLU(BN(conv(cat(x, ds_y))))))),
          out = x * att + ds_y * (2 - att).

The rest of the forward pass is convolutions, BatchNorm and pointwise ops
(cuDNN and plain torch on the card); the log-mel of
:meth:`ERes2NetV2Model.encode_batch` is one launch of kernel K2.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm
from .port import load_torch_layout


def _conv(c_in: int, c_out: int, k: int, stride=1, padding=0,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride=stride, padding=padding, bias=bias)


class AFF(nn.Module):
    """Attentional feature fusion of ``x`` and ``ds_y`` (same shape)."""

    def __init__(self, channels: int):
        super().__init__()
        inter = channels // 4
        self.local_att = nn.Sequential(
            _conv(2 * channels, inter, 1, bias=True), BatchNorm(inter), nn.SiLU(),
            _conv(inter, channels, 1, bias=True), BatchNorm(channels))

    def forward(self, x: torch.Tensor, ds_y: torch.Tensor) -> torch.Tensor:
        att = 1.0 + torch.tanh(self.local_att(torch.cat([x, ds_y], dim=1)))
        return x * att + ds_y * (2.0 - att)


class Block(nn.Module):
    """BasicBlockERes2NetV2 (``fuse``: the AFF variant of layers 3-4)."""

    def __init__(self, in_planes: int, planes: int, stride: int, width: int,
                 scale: int, expansion: int, fuse: bool):
        super().__init__()
        self.scale = scale
        out_planes = planes * expansion
        self.conv1 = _conv(in_planes, width * scale, 1, stride=stride)
        self.bn1 = BatchNorm(width * scale)
        self.convs = nn.ModuleList(_conv(width, width, 3, padding=1)
                                   for _ in range(scale))
        self.bns = nn.ModuleList(BatchNorm(width) for _ in range(scale))
        self.fuse_models = (nn.ModuleList(AFF(width) for _ in range(scale - 1))
                            if fuse else None)
        self.conv3 = _conv(width * scale, out_planes, 1)
        self.bn3 = BatchNorm(out_planes)
        self.shortcut = nn.Sequential()
        if stride != 1 or in_planes != out_planes:
            self.shortcut = nn.Sequential(
                _conv(in_planes, out_planes, 1, stride=stride),
                BatchNorm(out_planes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spx = torch.chunk(F.relu(self.bn1(self.conv1(x))), self.scale, dim=1)
        outs = []
        sp = spx[0]
        for i in range(self.scale):
            if i > 0:
                sp = (self.fuse_models[i - 1](sp, spx[i])
                      if self.fuse_models is not None else sp + spx[i])
            sp = F.relu(self.bns[i](self.convs[i](sp)))
            outs.append(sp)
        out = self.bn3(self.conv3(torch.cat(outs, dim=1)))
        del outs, spx, sp
        return F.relu(out + self.shortcut(x))


class ERes2NetV2(nn.Module):
    """fbank [B, T, n_mels] -> [B, emb_dim] float32."""

    def __init__(self, n_mels: int = 80, m_channels: int = 32,
                 base_width: int = 24, scale: int = 4, expansion: int = 4,
                 num_blocks: tuple[int, ...] = (3, 4, 6, 3), emb_dim: int = 192):
        super().__init__()
        self.n_mels = n_mels
        self.emb_dim = emb_dim
        planes = [m_channels, 2 * m_channels, 4 * m_channels, 8 * m_channels]
        self.conv1 = _conv(1, m_channels, 3, padding=1)
        self.bn1 = BatchNorm(m_channels)
        in_planes = m_channels
        for li, (p, n) in enumerate(zip(planes, num_blocks)):
            width = int(math.floor(p * (base_width / 64.0)))
            blocks = []
            for b in range(n):
                blocks.append(Block(in_planes, p, (1 if li == 0 else 2) if b == 0
                                    else 1, width, scale, expansion, li >= 2))
                in_planes = p * expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        c3, c4 = planes[2] * expansion, planes[3] * expansion
        self.layer3_ds = _conv(c3, c4, 3, stride=2, padding=1)
        self.fuse34 = AFF(c4)
        self.seg_1 = nn.Linear(c4 * (n_mels // 8) * 2, emb_dim)

    def manifest(self) -> dict[str, tuple[int, ...]]:
        """state_dict key -> shape (the checkpoint contract)."""
        return {k: tuple(v.shape) for k, v in self.state_dict().items()}

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats.transpose(1, 2)[:, None].float()               # [B, 1, F, T]
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer2(self.layer1(x))
        out3 = self.layer3(x)
        out4 = self.layer4(out3)
        fused = self.fuse34(out4, self.layer3_ds(out3))
        del x, out3, out4
        # TSTP: mean ++ std over time of [B, C*F, T]; the unbiased variance
        # as the JAX package forms it (no NaN at one frame) + 1e-7
        b, c, f, t = fused.shape
        h = fused.reshape(b, c * f, t)
        mu = h.mean(dim=2)
        var = h.var(dim=2, correction=0) * (t / max(t - 1, 1))
        stats = torch.cat([mu, torch.sqrt(var + 1e-7)], dim=1)
        return self.seg_1(stats).float()


class ERes2NetV2Model(nn.Module):
    """Waveform wrapper: ``encode_batch`` [B, T] -> [B, emb_dim]."""

    def __init__(self, net: ERes2NetV2 | None = None, sample_rate: int = 16000):
        super().__init__()
        self.net = net or ERes2NetV2()
        self.sample_rate = sample_rate

    def encode_batch(self, wavs: torch.Tensor) -> torch.Tensor:
        """:func:`~..dsp.mel.fbank_batch` at the net's mels with per-window
        mean-norm (one K2 launch on the card; the rows may be a strided
        view), then the net."""
        from ..dsp.mel import fbank_batch

        return self.net(fbank_batch(wavs, sample_rate=self.sample_rate,
                                    n_mels=self.net.n_mels))


def load_eres2netv2(src, net: ERes2NetV2 | None = None,
                    strict: bool = True) -> ERes2NetV2:
    """A 3D-Speaker ERes2NetV2 checkpoint into ``net`` (default: the
    published widths): a mapping of arrays or tensors (a JAX parameter dict
    as numpy loads as it is), a ``.onnx`` path (initializers keep the torch
    names) or a torch checkpoint path.  ``strict``: ``ValueError`` on a
    missing or unexpected key ("state_dict schema mismatch") or a wrong
    shape."""
    return load_torch_layout(net or ERes2NetV2(), src, strict)


def onnx_initializers(path) -> dict[str, np.ndarray]:
    """Named initializers of an ONNX graph (torch exports keep the
    parameter names): through the ``onnx`` package when it imports, else
    the port's own reader (:mod:`..io.onnx_lite`)."""
    try:
        import onnx
        from onnx import numpy_helper
    except ImportError:
        from ..io.onnx_lite import read_initializers

        return read_initializers(path)
    model = onnx.load(str(path))
    return {i.name: numpy_helper.to_array(i) for i in model.graph.initializer}

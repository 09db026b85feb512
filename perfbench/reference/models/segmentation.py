"""Chunk-local speaker-activity segmentation: the overlap detector and the
segmentation engine's net.

``SegNet`` on its ``arch='xf'`` branch (``segmentation_conv.npz``,
``segmentation_xf.npz``): log-mel [B, T, M] -> two SiLU convs at the 10 ms
rate -> a strided conv down to ``T // ds + 1`` tokens -> learned positions ->
``n_xf`` pre-LN transformer blocks that each see the whole 5 s chunk -> final
LayerNorm -> repeat-upsampled back to 10 ms and fused with the full-rate conv
features -> linear head.

The recurrent branches (``arch='gru'``: ``segmentation_ow3.npz``,
``segmentation_powerset.npz``, ``segmentation_synthetic.npz``) run ``n_gru``
bidirectional GRUs, each one ``nn.GRU(bidirectional=True)`` in place of the
JAX ``bigru_sequence`` (cuDNN on the card; torch's gate math is the JAX
``gru_sequence``'s, forward features first): at the 10 ms rate when ``ds == 1``, else over the SiLU of a strided
conv (``T // ds + 1`` steps), repeat-upsampled and fused with the full-rate
features as above.  ``n_fc`` SiLU linears follow either branch.

With ``powerset=True`` the head is one softmax over the ``2^K`` subsets of
the K speaker slots; the decision per frame is the argmax class, mapped to
its K binary slots by :meth:`SegNet.membership`.  With ``powerset=False``
(``segmentation_synthetic.npz``) it is K sigmoids, decided at 0.5.

The output is an argmax over near-tied logits on some frames, so the net
runs in float32 with TF32 off on the card (``utils.device.disable_tf32``),
and parity with another implementation is a share of equal decisions.  The
attention is spelled out as two products and a softmax: at 168 tokens a
head it is a few small float32 GEMMs, the same on the card and on the CPU.
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv1d_torch, layer_norm_apply
from .vad import _param


class SegNet(nn.Module):
    """Segmentation net: log-mel [B, T, M] -> head logits [B, T, n_out].
    Parameter names and layouts are the checkpoint's."""

    def __init__(self, n_mels: int = 40, channels: int = 96, hidden: int = 96,
                 n_speakers: int = 3, powerset: bool = False,
                 n_gru: int = 2, n_fc: int = 0, ds: int = 1,
                 arch: str = "gru", n_xf: int = 4, n_heads: int = 4,
                 max_frames: int = 501):
        super().__init__()
        if arch not in ("xf", "gru"):
            raise ValueError(f"unknown SegNet arch {arch!r}")
        self.n_mels = n_mels
        self.channels = channels
        self.hidden = hidden
        self.n_speakers = n_speakers
        self.powerset = powerset
        self.n_gru = n_gru
        self.n_fc = n_fc
        self.ds = ds
        self.arch = arch
        self.n_xf = n_xf
        self.n_heads = n_heads
        self.max_frames = max_frames
        c, h, m = channels, hidden, n_mels
        dm = 2 * h
        self.conv1_w, self.conv1_b = _param(c, m, 5), _param(c)
        self.conv2_w, self.conv2_b = _param(c, c, 3), _param(c)
        if arch == "xf":
            self.ds_w, self.ds_b = _param(dm, c, 2 * ds), _param(dm)
            self.pos_emb = _param(max_frames // ds + 2, dm)
            for i in range(1, n_xf + 1):
                for name, shape in (("ln1_g", (dm,)), ("ln1_b", (dm,)),
                                    ("qkv_w", (dm, 3 * dm)), ("qkv_b", (3 * dm,)),
                                    ("proj_w", (dm, dm)), ("proj_b", (dm,)),
                                    ("ln2_g", (dm,)), ("ln2_b", (dm,)),
                                    ("ff1_w", (dm, 4 * dm)), ("ff1_b", (4 * dm,)),
                                    ("ff2_w", (4 * dm, dm)), ("ff2_b", (dm,))):
                    setattr(self, f"xf{i}_{name}", _param(*shape))
            self.xf_lnf_g, self.xf_lnf_b = _param(dm), _param(dm)
            self.fuse_w, self.fuse_b = _param(dm + c, 2 * h), _param(2 * h)
        else:
            if ds > 1:
                self.ds_w, self.ds_b = _param(c, c, 2 * ds), _param(c)
                self.fuse_w, self.fuse_b = _param(2 * h + c, 2 * h), _param(2 * h)
            # gru{i}: the checkpoint's gru{i}_f / gru{i}_b pair
            for i in range(1, n_gru + 1):
                gru = nn.GRU(c if i == 1 else 2 * h, h, batch_first=True,
                             bidirectional=True)
                setattr(self, f"gru{i}", gru.requires_grad_(False))
        for i in range(1, n_fc + 1):
            setattr(self, f"fc{i}_w", _param(2 * h, 2 * h))
            setattr(self, f"fc{i}_b", _param(2 * h))
        self.out_w, self.out_b = _param(2 * h, self.n_out), _param(self.n_out)
        # not a weight: follows the module across devices, stays out of the
        # state dict
        self.register_buffer("memb", torch.from_numpy(self.membership()),
                             persistent=False)

    @property
    def n_out(self) -> int:
        return 2 ** self.n_speakers if self.powerset else self.n_speakers

    def membership(self) -> np.ndarray:
        """[2^K, K] binary matrix: class c contains speaker k iff bit k of c
        is set (class 0 = silence)."""
        k = self.n_speakers
        return ((np.arange(2 ** k)[:, None] >> np.arange(k)[None, :]) & 1
                ).astype(np.float32)

    @staticmethod
    def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return layer_norm_apply(x, g, b, eps=1e-5)

    def _xf_block(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Pre-LN transformer encoder block on [B, T_ds, D]."""
        p = lambda name: getattr(self, f"xf{i + 1}_{name}")  # noqa: E731
        b, t, dm = x.shape
        nh = self.n_heads
        hd = dm // nh
        h1 = self._ln(x, p("ln1_g"), p("ln1_b"))
        qkv = h1 @ p("qkv_w") + p("qkv_b")
        # [B, T, 3, nh, hd] -> three [B, nh, T, hd]
        q, k, v = qkv.reshape(b, t, 3, nh, hd).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(float(hd)), -1)
        o = (att @ v).transpose(1, 2).reshape(b, t, dm)
        x = x + o @ p("proj_w") + p("proj_b")
        h2 = self._ln(x, p("ln2_g"), p("ln2_b"))
        # the tanh approximation, the default of the net's training framework
        f = F.gelu(h2 @ p("ff1_w") + p("ff1_b"), approximate="tanh")
        return x + f @ p("ff2_w") + p("ff2_b")

    def logits(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, M] log-mel -> [B, T, n_out] raw head logits."""
        x = feats.transpose(1, 2)                                 # [B, M, T]
        x = F.silu(conv1d_torch(x, self.conv1_w, self.conv1_b, padding=2))
        x = F.silu(conv1d_torch(x, self.conv2_w, self.conv2_b, padding=2,
                                dilation=2))
        xt = x.transpose(1, 2)               # [B, T, C] full-rate features
        d = self.ds
        if self.arch == "gru" and d == 1:
            x = xt
            for i in range(1, self.n_gru + 1):
                x = getattr(self, f"gru{i}")(x)[0]
        else:
            xd = conv1d_torch(x, self.ds_w, self.ds_b, stride=d, padding=d)
            g = F.silu(xd.transpose(1, 2))                   # [B, T_ds, D]
            if self.arch == "gru":
                for i in range(1, self.n_gru + 1):
                    g = getattr(self, f"gru{i}")(g)[0]
            else:
                if g.shape[1] > self.pos_emb.shape[0]:
                    raise ValueError(
                        f"{feats.shape[1]} frames give {g.shape[1]} tokens, more "
                        f"than the {self.pos_emb.shape[0]} learned positions")
                g = g + self.pos_emb[:g.shape[1]]
                for i in range(self.n_xf):
                    g = self._xf_block(i, g)
                g = self._ln(g, self.xf_lnf_g, self.xf_lnf_b)
            # repeat-upsample the ds-rate context back to the 10 ms grid and
            # fuse it with the full-rate conv features: boundaries keep 10 ms
            up = g.repeat_interleave(d, dim=1)[:, :xt.shape[1]]
            x = F.silu(torch.cat([up, xt], dim=-1) @ self.fuse_w + self.fuse_b)
        for i in range(1, self.n_fc + 1):
            x = F.silu(x @ getattr(self, f"fc{i}_w") + getattr(self, f"fc{i}_b"))
        return x @ self.out_w + self.out_b

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """-> [B, T, K] per-speaker activities in [0, 1] (both heads)."""
        logits = self.logits(feats)
        if not self.powerset:
            return torch.sigmoid(logits)
        # marginalize the class posterior: P(speaker k) = sum of P(class c)
        # over the classes that contain k
        return torch.softmax(logits, dim=-1) @ self.memb

    def hard_from_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """Head logits -> [.., K] binary activities by the head's own
        decision: argmax over the powerset classes (first index on ties), or
        a 0.5 threshold on the sigmoid head."""
        if not self.powerset:
            return (torch.sigmoid(logits) >= 0.5).float()
        return self.memb[torch.argmax(logits, dim=-1)]

    def apply_hard(self, feats: torch.Tensor) -> torch.Tensor:
        """-> [B, T, K] binary activities."""
        return self.hard_from_logits(self.logits(feats))


class SegmentationModel(nn.Module):
    """Waveform wrapper: [B, T_samples] -> [B, n_frames, K] local activities
    at ``hop_ms``.  The log-mel is K2 (:func:`~..dsp.mel.fused_log_mel`): one
    kernel launch for the batch on the card, the plain batched version on
    the CPU."""

    def __init__(self, net: SegNet, sample_rate: int = 16000,
                 hop_ms: float = 10.0, win_ms: float = 25.0):
        super().__init__()
        self.net = net
        self.sample_rate = sample_rate
        self.hop_ms = hop_ms
        self.win_ms = win_ms

    def _feats(self, y: torch.Tensor) -> torch.Tensor:
        from ..dsp.mel import fused_log_mel

        feats = fused_log_mel(y, sample_rate=self.sample_rate,
                              n_mels=self.net.n_mels, win_ms=self.win_ms,
                              hop_ms=self.hop_ms)
        return (feats + 6.0) * 0.25   # the fixed affine rescale of the VAD

    def head_logits(self, y: torch.Tensor) -> torch.Tensor:
        """[B, T_samples] -> [B, n_frames, n_out] raw head logits."""
        return self.net.logits(self._feats(y))

    def activities(self, y: torch.Tensor) -> torch.Tensor:
        """[B, T_samples] or [T_samples] -> soft activities."""
        if y.ndim == 1:
            return self.net(self._feats(y[None]))[0]
        return self.net(self._feats(y))

    def hard_activities(self, y: torch.Tensor) -> torch.Tensor:
        """[B, T_samples] or [T_samples] -> binary activities by the head's
        own decision (see :meth:`SegNet.hard_from_logits`)."""
        if y.ndim == 1:
            return self.net.apply_hard(self._feats(y[None]))[0]
        return self.net.apply_hard(self._feats(y))


def seeded_init(net: SegNet, seed: int = 0) -> SegNet:
    """Random weights for a net whose checkpoint is missing, from a seeded
    ``torch.Generator``: He-normal linears and convolutions, GRU weights
    uniform in +-1/sqrt(hidden), layer-norm gains one, positions 0.02 N(0, 1),
    biases zero.  The activities are meaningless; the run is reproducible."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("_g"):
                p.fill_(1.0)
            elif name == "pos_emb":
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
            elif name.startswith("gru"):
                bound = net.hidden ** -0.5
                p.copy_((2.0 * torch.rand(p.shape, generator=g) - 1.0) * bound)
            elif p.ndim >= 2:
                fan_in = p.shape[1] * p.shape[2] if p.ndim == 3 else p.shape[0]
                p.copy_(torch.randn(p.shape, generator=g) * (2.0 / fan_in) ** 0.5)
            else:
                p.zero_()
    return net


def pit_bce_loss(pred: torch.Tensor, target: torch.Tensor,
                 eps: float = 1e-7) -> torch.Tensor:
    """Permutation-invariant BCE over the K speaker slots: pred / target
    [B, T, K]; each chunk takes the least mean BCE over the K! slot
    permutations."""
    k = pred.shape[-1]
    losses = []
    for perm in itertools.permutations(range(k)):
        p = pred[..., list(perm)]
        bce = -(target * torch.log(p + eps) + (1 - target) * torch.log(1 - p + eps))
        losses.append(bce.mean(dim=(1, 2)))                         # [B]
    return torch.stack(losses).min(dim=0).values.mean()


def powerset_pit_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                         overlap_weight: float = 0.0) -> torch.Tensor:
    """Permutation-invariant cross-entropy over the speaker-subset powerset:
    logits [B, T, 2^K], target [B, T, K] binary activities.  A permutation's
    target class is its permuted activity pattern read as a binary number;
    each chunk takes the least mean CE over the K! permutations.  Frames
    with two or more active speakers weigh ``1 + overlap_weight``, the
    weights renormalized to a mean of one per chunk."""
    k = target.shape[-1]
    logp = torch.log_softmax(logits, dim=-1)                        # [B, T, C]
    weights = 2 ** torch.arange(k, device=logits.device)
    tgt = (target > 0.5).long()
    fw = 1.0 + overlap_weight * (tgt.sum(-1) >= 2).to(logp.dtype)   # [B, T]
    fw = fw / fw.mean(dim=1, keepdim=True)
    losses = []
    for perm in itertools.permutations(range(k)):
        cls = (tgt[..., list(perm)] * weights).sum(-1)              # [B, T]
        ce = -torch.gather(logp, -1, cls[..., None])[..., 0]
        losses.append((fw * ce).mean(dim=1))                        # [B]
    return torch.stack(losses).min(dim=0).values.mean()


def best_permutation_accuracy(pred: np.ndarray, target: np.ndarray) -> float:
    """Frame accuracy after the best slot permutation of each chunk (the
    probe metric: slot identity means something only within a chunk)."""
    k = pred.shape[-1]
    if pred.ndim == 2:
        pred, target = pred[None], target[None]
    p = pred > 0.5
    t = target > 0.5
    accs = np.stack([(p[..., list(perm)] == t).mean(axis=(1, 2))
                     for perm in itertools.permutations(range(k))])  # [K!, B]
    return float(accs.max(axis=0).mean())

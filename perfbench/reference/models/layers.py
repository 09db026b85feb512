"""NN primitives with the JAX package's semantics and torch weight layouts."""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def conv1d_torch(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor | None = None, stride: int = 1,
                 padding: int = 0, dilation: int = 1,
                 groups: int = 1) -> torch.Tensor:
    """``F.conv1d`` (cross-correlation) over [B, C_in, T] with weight
    [C_out, C_in/groups, K]."""
    return F.conv1d(x, weight, bias, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def layer_norm_apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    """``nn.LayerNorm`` over the trailing ``gamma.ndim`` dims: biased
    variance, ``(x - mean) / sqrt(var + eps) * gamma + beta``."""
    return F.layer_norm(x, tuple(gamma.shape), gamma, beta, eps)


def batch_norm_apply(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                     gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
                     channel_axis: int = 1) -> torch.Tensor:
    """Inference BatchNorm with running statistics.  Scale and shift are
    computed from the (float32) parameters and cast to the activation dtype,
    so a bf16 activation stays bf16 — the JAX package's cast points."""
    shape = [1] * x.ndim
    shape[channel_axis] = x.shape[channel_axis]
    sd = torch.sqrt(var + eps)
    scale = (gamma / sd).reshape(shape)
    shift = (beta - mean * gamma / sd).reshape(shape)
    return x * scale.to(x.dtype) + shift.to(x.dtype)


def make_trainable(net: nn.Module) -> nn.Module:
    """Every leaf of the JAX parameter tree as a trainable tensor, in place:
    each parameter requires grad, and each persistent floating buffer (the
    BatchNorm running statistics, leaves of the JAX tree that its recipes
    train in eval-mode BN) becomes a parameter under the same name, so the
    ``state_dict`` keys do not change.  Non-persistent buffers (constants
    derived from the weights) stay buffers."""
    for mod in net.modules():
        for name, buf in list(mod._buffers.items()):
            if (buf is None or name in mod._non_persistent_buffers_set
                    or not buf.is_floating_point()):
                continue
            del mod._buffers[name]
            mod.register_parameter(name, nn.Parameter(buf.detach()))
    for p in net.parameters():
        p.requires_grad_(True)
    return net


class BatchNorm(nn.Module):
    """Inference BatchNorm over axis 1 (:func:`batch_norm_apply`) whose
    ``state_dict`` keys are those of torch's ``nn.BatchNorm1d/2d`` less
    ``num_batches_tracked``: ``weight`` and ``bias`` when ``affine``,
    ``running_mean`` and ``running_var``.  Non-affine: gamma one, beta zero,
    as the JAX package applies it."""

    def __init__(self, c: int, affine: bool = True):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.ones(c), requires_grad=False)
            self.bias = nn.Parameter(torch.zeros(c), requires_grad=False)
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gamma = self.weight if self.weight is not None else torch.ones_like(
            self.running_var)
        beta = self.bias if self.bias is not None else torch.zeros_like(
            self.running_var)
        return batch_norm_apply(x, self.running_mean, self.running_var, gamma,
                                beta)


# Per-shape constants live on the device once: a host-to-device copy from
# pageable memory inside the per-chunk program would make the host wait for
# the device and serialize dispatch with compute.  They are made outside
# inference mode: one first made under ``torch.inference_mode()`` would be
# an inference tensor, which autograd cannot save for a training backward.
_CONSTS: dict = {}


def _band(b: int, h0: int, h1: int, device) -> torch.Tensor:
    key = ("band", b, h0, h1, str(device))
    if key not in _CONSTS:
        k = np.arange(3 * b)[:, None] - b                   # input offset
        o = np.arange(b)[None, :]                           # output pos
        band = ((k >= o - h0) & (k <= o + h1)).astype(np.float32)
        with torch.inference_mode(False):
            _CONSTS[key] = torch.from_numpy(band).to(device)
    return _CONSTS[key]


def _counts(t: int, h0: int, h1: int, device) -> torch.Tensor:
    """Window population of each position (clamped at both edges)."""
    key = ("cnt", t, h0, h1, str(device))
    if key not in _CONSTS:
        pos = np.arange(t)
        cnt = np.clip(pos + h1 + 1, 0, t) - np.clip(pos - h0, 0, t)
        with torch.inference_mode(False):
            _CONSTS[key] = torch.from_numpy(cnt.astype(np.float32)).to(device)
    return _CONSTS[key]


def sliding_mean_time(x: torch.Tensor, win: int,
                      backend: str = "auto") -> torch.Tensor:
    """Centered moving average over the trailing (time) axis, same length.

    Edge positions average over the clamped valid range (a shrinking window):
    position ``p`` averages ``[p - h0, p + h1]`` with ``h0 = win // 2`` and
    ``h1 = win - 1 - h0``, divided by the number of those frames that exist.
    An off-by-one here shifts every embedding near a chunk edge, which shows
    only in the cross-chunk stitch.

    ``backend``, as in the JAX package: ``banded`` contracts blocks of ``B``
    frames against a [3B, B] 0/1 band matrix in float32 (TF32 off on the
    card); ``cumsum`` differences a float32 prefix sum over an
    edge-replicated padding of it (two static slices; its rounding grows
    with the prefix, see PERF.md); ``auto`` takes ``SDTPU_SLIDING_BACKEND``
    when set, else banded for half-widths up to 512 and cumsum above.
    Returns ``x.dtype``.
    """
    t = x.shape[-1]
    h0 = win // 2
    h1 = win - 1 - h0
    cnt = _counts(t, h0, h1, x.device)
    if backend == "auto":
        backend = os.environ.get("SDTPU_SLIDING_BACKEND", "auto")
    if backend == "auto":
        backend = "banded" if max(h0, h1) <= 512 else "cumsum"
    if backend == "banded":
        b = max(128, -(-max(h0, h1, 1) // 128) * 128)
        n = -(-t // b)
        xp = F.pad(x.float(), (0, n * b - t))
        xb = xp.reshape(*x.shape[:-1], n, b)
        zero = torch.zeros_like(xb[..., :1, :])
        prev = torch.cat([zero, xb[..., :-1, :]], dim=-2)
        nxt = torch.cat([xb[..., 1:, :], zero], dim=-2)
        x3 = torch.cat([prev, xb, nxt], dim=-1)             # [..., n, 3B]
        s = x3 @ _band(b, h0, h1, x.device)
        s = s.reshape(*x.shape[:-1], n * b)[..., :t]
        return (s / cnt).to(x.dtype)
    if backend != "cumsum":
        raise ValueError(f"sliding_mean_time: unknown backend {backend!r}")
    cs = torch.cumsum(x.float(), dim=-1)
    # padded[i] = cs[clip(i - h0, 0, t)] with cs[0] = 0: the window sum of
    # position p is padded[p + win] - padded[p]
    lead = cs.shape[:-1]
    padded = torch.cat([cs.new_zeros(*lead, h0 + 1), cs,
                        cs[..., -1:].expand(*lead, h1)], dim=-1)
    s = padded[..., win:win + t] - padded[..., :t]
    return (s / cnt).to(x.dtype)

"""Sample-rate conversion, the JAX package's ``dsp/resample.py``:

* :func:`resample_host`: scipy's polyphase ``resample_poly`` on the host in
  float64 (the I/O path);
* :func:`resample_poly`: the same on the tensor's device: kernel K3
  (``csrc/resample_poly.cu``) for a CUDA tensor, :func:`resample_host` for a
  CPU one (the demix front-end's 16 <-> 44.1 kHz legs);
* :func:`_polyphase_walk`: K3's walk over its outputs in plain torch, the
  index arithmetic the CPU tests hold to scipy.
"""
from __future__ import annotations

from functools import lru_cache
from math import gcd

import numpy as np
import torch

from ..ops import cost, kernels

# periods of ``up`` outputs in one of K3's tiles: upsampling, a thread owns
# one output of each; downsampling, each lane of a warp owns one period
K3_PERIODS = 8
K3_LANES = 32


@lru_cache(maxsize=32)
def _poly_filter(up: int, down: int) -> np.ndarray:
    """The Kaiser-windowed lowpass of ``scipy.signal.resample_poly``'s
    defaults (``2 * 10 * max(up, down) + 1`` taps, beta 5), gain ``up``."""
    from scipy import signal as sps

    max_rate = max(up, down)
    h = sps.firwin(2 * 10 * max_rate + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float64)


@lru_cache(maxsize=32)
def _poly_bank(up: int, down: int) -> np.ndarray:
    """:func:`_poly_filter` reordered by phase: ``[up, n_taps]`` float64,
    ``bank[r, i] = h[r + i * up]``, zero past the filter's end
    (``n_taps = ceil(len(h) / up)``, the longest phase)."""
    h = _poly_filter(up, down)
    n_taps = -(-h.size // up)
    padded = np.zeros(up * n_taps)
    padded[:h.size] = h
    return np.ascontiguousarray(padded.reshape(n_taps, up).T)


def _ratio(orig_sr: int, target_sr: int) -> tuple[int, int]:
    g = gcd(orig_sr, target_sr)
    return target_sr // g, orig_sr // g


def resample_host(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Host polyphase resampling along the last axis (scipy), float32 out."""
    if orig_sr == target_sr:
        return np.asarray(y, dtype=np.float32)
    from scipy import signal as sps

    up, down = _ratio(orig_sr, target_sr)
    out = sps.resample_poly(np.asarray(y, dtype=np.float64), up, down, axis=-1)
    return out.astype(np.float32)


def _polyphase_walk(y: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """K3's arithmetic in plain torch: ``[T]`` or ``[C, T]`` -> ``[...,
    ceil(T * up / down)]`` float64, the sums before their rounding to
    float32 (a ``[T]`` wave is one row, as the wrapper launches it).

    A tile holds ``P`` periods of ``up`` outputs (``K3_PERIODS``
    upsampling, ``K3_LANES`` downsampling); output ``m`` lies in tile ``m //
    (P * up)``, period ``k`` and residue ``q``.  Its phase is ``(m * down +
    half) % up`` and its newest input sample ``(m * down + half) // up``,
    both computed from the tile, ``k`` and ``q`` as the kernel does, and its
    taps ``bank[phase, i]`` meet sample ``newest - i`` in order of ``i``; a
    tap off the wave meets a zero of the staged span."""
    bank = torch.from_numpy(_poly_bank(up, down))
    n_taps = bank.shape[1]
    half = (_poly_filter(up, down).size - 1) // 2
    x = (y if y.ndim == 2 else y[None]).to(torch.float64)
    c, t = x.shape
    n_out = -(-t * up // down)
    periods = K3_PERIODS if down < up else K3_LANES
    n_tiles = -(-n_out // (periods * up))
    tile, k, q = torch.meshgrid(torch.arange(n_tiles), torch.arange(periods),
                                torch.arange(up), indexing="ij")
    m = (tile * periods * up + k * up + q).flatten()
    phase = ((q * down + half) % up).flatten()
    newest = (tile * periods * down + k * down + (q * down + half) // up).flatten()
    keep = m < n_out
    m, phase, newest = m[keep], phase[keep], newest[keep]
    acc = torch.zeros((c, m.numel()), dtype=torch.float64)
    for i in range(n_taps):
        j = newest - i
        on = (j >= 0) & (j < t)
        acc += bank[phase, i] * torch.where(on, x[:, j.clamp(0, t - 1)], 0.0)
    out = torch.empty((c, n_out), dtype=torch.float64)
    out[:, m] = acc
    return out if y.ndim == 2 else out[0]


_BANKS: dict = {}


def _device_bank(up: int, down: int, device) -> torch.Tensor:
    """The phase bank on ``device``, copied there once per ``(up, down)``."""
    key = (up, down, str(device))
    if key not in _BANKS:
        _BANKS[key] = torch.from_numpy(_poly_bank(up, down)).to(device)
    return _BANKS[key]


def resample_poly(y: torch.Tensor, orig_sr: int, target_sr: int) -> torch.Tensor:
    """Polyphase resampling of a [T] or [C, T] float32 tensor along its last
    axis on its device, ``ceil(T * up / down)`` samples out: scipy's
    ``resample_poly`` with its default filter (:func:`resample_host`'s
    arithmetic).  CPU tensor: :func:`resample_host`.  CUDA tensor: ONE
    launch of K3 (``csrc/resample_poly.cu``; contiguous float32, no
    backward), or an exception; it sums each output in float64 over the taps
    that fall on samples and rounds once, so it agrees with scipy to a
    float32 rounding."""
    if orig_sr == target_sr:
        return y
    if y.ndim not in (1, 2):
        raise ValueError(f"expected a [T] or [C, T] waveform, got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return torch.from_numpy(resample_host(y.detach().numpy(), orig_sr, target_sr))
    kernels.refuse_autograd("resample_poly", y)
    kernels.check_cuda_tensor(y, "resample_poly: y", torch.float32)
    up, down = _ratio(orig_sr, target_sr)
    bank = _device_bank(up, down, y.device)
    x = y if y.ndim == 2 else y[None]
    c, t = x.shape
    if c < 1 or t < 1:
        raise ValueError(f"resample_poly: y: expected samples, got {tuple(y.shape)}")
    n_out = -(-t * up // down)
    out = torch.empty((c, n_out), dtype=torch.float32, device=y.device)
    n_taps = bank.shape[1]
    half = (_poly_filter(up, down).size - 1) // 2
    kernels.launch(
        "resample_poly", x.data_ptr(), c, t, bank.data_ptr(), up, down, n_taps,
        half, out.data_ptr(), n_out,
        torch.cuda.current_stream(y.device).cuda_stream, device=y.device,
        form="[T]" if y.ndim == 1 else "[C, T]", shape=f"up {up} down {down}",
        work=lambda: cost.resample_poly_work(c, t, n_out, up, down))
    return out[0] if y.ndim == 1 else out

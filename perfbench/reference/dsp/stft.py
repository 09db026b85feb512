"""STFT / iSTFT with the JAX package's semantics (``dsp/stft.py``):
``center=True`` reflect padding by default, a periodic sqrt-Hann window of
``win_length`` points centred in ``n_fft`` unless one is given, and a
length-restoring inverse with window-square normalization.

:func:`stft_ri` / :func:`istft_ri` take spectra as real pairs
``[..., n_bins, n_frames, 2]`` (real, imag): float32 matrix products
against the real-DFT bases (one product each: cosine and sine columns side
by side), as the JAX package computes them; TF32 must be off on the card
(``utils.device.disable_tf32``).  :func:`stft` / :func:`istft` take complex
``[..., n_bins, n_frames]`` spectra: the same products by default
(``matmul``), or ``torch.fft.rfft`` / ``irfft`` as the JAX package's FFT
form.  The products give an exact zero for the imaginary part of the DC
and Nyquist bins; an FFT keeps rounding noise there.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from .ola import overlap_add


# Device constants, made once.  They are made outside inference mode: one
# first made under ``torch.inference_mode()`` (a pipeline's call) would be an
# inference tensor, which autograd cannot save for a training step's
# backward.
_CONSTS: dict = {}


def hann_window(n: int, periodic: bool = True, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """``torch.hann_window`` values, computed in float64 and stored as
    ``dtype``; made once per length, dtype and device (the enhancer's chunk
    window has 5.76 M points) and shared, so callers must not write to it."""
    key = ("hann", n, periodic, dtype, str(device))
    if key not in _CONSTS:
        m = n if periodic else n - 1
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(m, 1))
        with torch.inference_mode(False):
            _CONSTS[key] = torch.tensor(w, dtype=dtype, device=device)
    return _CONSTS[key]


def sqrt_hann_window(n: int, periodic: bool = True, dtype: torch.dtype = torch.float32,
                     device=None) -> torch.Tensor:
    """sqrt(Hann) taken in ``dtype``: the GTCRN runner's analysis and
    synthesis window."""
    key = ("sqrt_hann", n, periodic, dtype, str(device))
    if key not in _CONSTS:
        with torch.inference_mode(False):
            _CONSTS[key] = torch.sqrt(torch.clamp(
                hann_window(n, periodic, dtype, device), min=0.0))
    return _CONSTS[key]


@lru_cache(maxsize=8)
def _dft_matrix(n_fft: int) -> np.ndarray:
    """Real-DFT basis [n_fft, 2*n_bins]: the cosine columns, then -sine."""
    n_bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * np.arange(n_bins)[None, :] / n_fft
    return np.concatenate([np.cos(ang).astype(np.float32),
                           (-np.sin(ang)).astype(np.float32)], axis=1)


@lru_cache(maxsize=8)
def _idft_matrix(n_fft: int) -> np.ndarray:
    """Inverse real-DFT basis [2*n_bins, n_fft]: frames = [re | im] @ it.
    Interior bins count twice (conjugate symmetry); DC and Nyquist once."""
    n_bins = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(n_bins)[:, None] * np.arange(n_fft)[None, :] / n_fft
    w = np.full((n_bins, 1), 2.0)
    w[0, 0] = 1.0
    if n_fft % 2 == 0:
        w[-1, 0] = 1.0
    return np.concatenate([(w * np.cos(ang) / n_fft).astype(np.float32),
                           (-w * np.sin(ang) / n_fft).astype(np.float32)], axis=0)


def _const(name: str, n_fft: int, device) -> torch.Tensor:
    """A basis on ``device``, copied there once."""
    key = (name, n_fft, str(device))
    if key not in _CONSTS:
        a = _dft_matrix(n_fft) if name == "dft" else _idft_matrix(n_fft)
        with torch.inference_mode(False):
            _CONSTS[key] = torch.from_numpy(a).to(device)
    return _CONSTS[key]


def _window(n_fft: int, win_length: int | None, window: torch.Tensor | None,
            device) -> torch.Tensor:
    """The analysis / synthesis window as ``n_fft`` points: sqrt-Hann of
    ``win_length`` unless ``window`` is given, zero-padded to ``n_fft`` on
    both sides when shorter."""
    win_length = win_length or n_fft
    if window is None:
        window = sqrt_hann_window(win_length, device=device)
    else:
        window = window.to(device=device, dtype=torch.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _frames(y: torch.Tensor, n_fft: int, hop: int, window: torch.Tensor,
            center: bool) -> torch.Tensor:
    """[B, T] -> windowed frames [B, n, n_fft] (reflect-padded by
    ``n_fft // 2`` when ``center``; no frame past the end)."""
    if center:
        pad = n_fft // 2
        y = F.pad(y, (pad, pad), mode="reflect")
    return y.unfold(-1, n_fft, hop) * window


def _synthesize(frames: torch.Tensor, window: torch.Tensor, hop: int,
                n_fft: int, center: bool, length: int | None) -> torch.Tensor:
    """Windowed overlap-add of [B, n, n_fft] frames, normalized by the
    overlapped squared window, trimmed of the centre pads."""
    frames = frames * window
    y = overlap_add(frames, hop)
    wsq = overlap_add((window * window).expand(1, frames.shape[1], n_fft), hop)
    y = y / torch.clamp(wsq, min=1e-11)
    if center:
        pad = n_fft // 2
        y = y[:, pad:]
        y = y[:, :length] if length is not None else y[:, :y.shape[1] - pad]
    elif length is not None:
        y = y[:, :length]
    return y


def stft_ri(y: torch.Tensor, n_fft: int = 512, hop: int = 256,
            win_length: int | None = None, window: torch.Tensor | None = None,
            center: bool = True) -> torch.Tensor:
    """[T] or [B, T] float32 -> real pairs [..., n_bins, n_frames, 2]
    (``1 + T//hop`` frames when ``center``)."""
    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    frames = _frames(y, n_fft, hop, _window(n_fft, win_length, window, y.device),
                     center)                                     # [B, n, n_fft]
    n_bins = n_fft // 2 + 1
    ri = (frames @ _const("dft", n_fft, y.device)).reshape(
        *frames.shape[:2], 2, n_bins)                            # [B, n, 2, k]
    out = ri.permute(0, 3, 1, 2)                                 # [B, k, n, 2]
    return out[0] if squeeze else out


def istft_ri(spec_ri: torch.Tensor, n_fft: int = 512, hop: int = 256,
             length: int | None = None, win_length: int | None = None,
             window: torch.Tensor | None = None,
             center: bool = True) -> torch.Tensor:
    """Real pairs [..., n_bins, n_frames, 2] -> [..., T] (``length`` samples
    when given, else the frames' span less the centre pads)."""
    squeeze = spec_ri.ndim == 3
    if squeeze:
        spec_ri = spec_ri[None]
    ri = spec_ri.permute(0, 2, 3, 1)                             # [B, n, 2, k]
    frames = ri.reshape(*ri.shape[:2], -1) @ _const("idft", n_fft, spec_ri.device)
    y = _synthesize(frames, _window(n_fft, win_length, window, spec_ri.device),
                    hop, n_fft, center, length)
    return y[0] if squeeze else y


def spec_as_real(spec: torch.Tensor) -> torch.Tensor:
    """complex [..., F, T] -> real [..., F, T, 2] (real, imag)."""
    return torch.stack([spec.real, spec.imag], dim=-1)


def real_as_spec(x: torch.Tensor) -> torch.Tensor:
    """real [..., F, T, 2] -> complex [..., F, T]."""
    return torch.complex(x[..., 0].contiguous(), x[..., 1].contiguous())


def stft(y: torch.Tensor, n_fft: int = 512, hop: int = 256,
         win_length: int | None = None, window: torch.Tensor | None = None,
         center: bool = True, matmul: bool | None = None) -> torch.Tensor:
    """STFT of [..., T] -> complex64 [..., n_bins, n_frames] (torch layout).
    ``matmul`` (the default, None) forms it from :func:`stft_ri`'s
    products; ``matmul=False`` with ``torch.fft.rfft``."""
    if matmul is None or matmul:
        return real_as_spec(stft_ri(y, n_fft, hop, win_length, window, center))
    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    frames = _frames(y, n_fft, hop, _window(n_fft, win_length, window, y.device),
                     center)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1).transpose(1, 2)
    return spec[0] if squeeze else spec


def istft(spec: torch.Tensor, n_fft: int = 512, hop: int = 256,
          win_length: int | None = None, window: torch.Tensor | None = None,
          center: bool = True, length: int | None = None,
          matmul: bool | None = None) -> torch.Tensor:
    """Inverse STFT of complex [..., n_bins, n_frames] -> [..., T]: weighted
    overlap-add with window-square normalization.  ``matmul`` as in
    :func:`stft`."""
    if matmul is None or matmul:
        return istft_ri(spec_as_real(spec), n_fft, hop, length, win_length,
                        window, center)
    squeeze = spec.ndim == 2
    if squeeze:
        spec = spec[None]
    frames = torch.fft.irfft(spec.transpose(1, 2), n=n_fft, dim=-1)
    y = _synthesize(frames, _window(n_fft, win_length, window, spec.device),
                    hop, n_fft, center, length)
    return y[0] if squeeze else y

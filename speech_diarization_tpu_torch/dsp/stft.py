"""STFT / iSTFT over real-pair spectra, with the JAX package's semantics
(``dsp/stft.py::stft_ri`` / ``istft_ri``) at the GTCRN runner's settings:
``center=True`` reflect padding, a periodic sqrt-Hann window of ``n_fft``
points, spectra as ``[..., n_bins, n_frames, 2]`` (real, imag), and a
length-restoring inverse with window-square normalization.

Both directions are float32 matrix products against the real-DFT bases
(one product each: cosine and sine columns side by side), as the JAX
package computes them; TF32 must be off on the card
(``utils.device.disable_tf32``).
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


def hann_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    """``torch.hann_window`` values, computed in float64 and stored float32;
    made once per length and device (the enhancer's chunk window has 5.76 M
    points) and shared, so callers must not write to it."""
    key = ("hann", n, periodic, str(device))
    if key not in _CONSTS:
        m = n if periodic else n - 1
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / max(m, 1))
        with torch.inference_mode(False):
            _CONSTS[key] = torch.tensor(w, dtype=torch.float32, device=device)
    return _CONSTS[key]


def sqrt_hann_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    """sqrt(Hann): the GTCRN runner's analysis and synthesis window."""
    key = ("sqrt_hann", n, periodic, str(device))
    if key not in _CONSTS:
        with torch.inference_mode(False):
            _CONSTS[key] = torch.sqrt(torch.clamp(
                hann_window(n, periodic, device), min=0.0))
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


def stft_ri(y: torch.Tensor, n_fft: int = 512, hop: int = 256) -> torch.Tensor:
    """[T] or [B, T] float32 -> real pairs [..., n_bins, 1 + T//hop, 2]."""
    squeeze = y.ndim == 1
    if squeeze:
        y = y[None]
    pad = n_fft // 2
    y = F.pad(y, (pad, pad), mode="reflect")
    frames = (y.unfold(-1, n_fft, hop)
              * sqrt_hann_window(n_fft, device=y.device))      # [B, n, n_fft]
    n_bins = n_fft // 2 + 1
    ri = (frames @ _const("dft", n_fft, y.device)).reshape(
        *frames.shape[:2], 2, n_bins)                            # [B, n, 2, k]
    out = ri.permute(0, 3, 1, 2)                                 # [B, k, n, 2]
    return out[0] if squeeze else out


def istft_ri(spec_ri: torch.Tensor, n_fft: int = 512, hop: int = 256,
             length: int | None = None) -> torch.Tensor:
    """Real pairs [..., n_bins, n_frames, 2] -> [..., T] (``length`` samples
    when given, else the frames' span less the centre pads)."""
    window = sqrt_hann_window(n_fft, device=spec_ri.device)
    squeeze = spec_ri.ndim == 3
    if squeeze:
        spec_ri = spec_ri[None]
    ri = spec_ri.permute(0, 2, 3, 1)                             # [B, n, 2, k]
    frames = ri.reshape(*ri.shape[:2], -1) @ _const("idft", n_fft, spec_ri.device)
    frames = frames * window                                     # [B, n, n_fft]
    y = overlap_add(frames, hop)
    wsq = overlap_add((window * window).expand(1, frames.shape[1], n_fft), hop)
    y = y / torch.clamp(wsq, min=1e-11)
    pad = n_fft // 2
    y = y[:, pad:]
    y = y[:, :length] if length is not None else y[:, :y.shape[1] - pad]
    return y[0] if squeeze else y

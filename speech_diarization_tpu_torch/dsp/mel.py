"""Log-mel filterbank features (25 ms Hann window, 10 ms hop, HTK mel scale,
no filterbank norm, ``log(x + 1e-6)``), on the tensor's device.

Holds kernel K2 and its plain version:

* :func:`_log_mel_1d` — the plain PyTorch version: the B==1 blocked
  windowed-DFT form of the JAX package (``dsp/mel.py::_log_mel_1d``), the
  form its main path ran.  Frame ``i`` spans ``k = ceil(n_fft/hop)`` hop
  blocks of the reflect-padded signal, so the DFT is ``k`` accumulated
  products over contiguous block slices.
* :func:`fused_log_mel` — the wrapper of the CUDA kernel
  ``csrc/fused_fbank.cu`` (the port of the Pallas ``fused_log_mel``).  On a
  CPU tensor it returns the plain version; on a CUDA tensor it launches the
  kernel or raises.

The reflect pad needs ``T > n_fft // 2`` samples; shorter inputs raise (the
JAX path clamps its pad without a word there).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import kernels


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@lru_cache(maxsize=8)
def _mel_filterbank_np(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """Triangular HTK-scale mel filterbank [n_freqs, n_mels], norm=None —
    the ``torchaudio.functional.melscale_fbanks`` construction."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min, m_max = _hz_to_mel(f_min), _hz_to_mel(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)


@lru_cache(maxsize=8)
def _dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis as two dense [n_fft, n_bins] matrices (cos, -sin)."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft)[:, None]
    k = np.arange(n_bins)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@lru_cache(maxsize=8)
def _windowed_dft(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Periodic-Hann-windowed DFT basis [n_fft, n_bins] (cos, -sin): the
    window folds into the contraction axis."""
    window = (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
              ).astype(np.float32)
    cos_m, msin_m = _dft_matrices(n_fft)
    return cos_m * window[:, None], msin_m * window[:, None]


def _frame_params(sample_rate: int, win_ms: float, hop_ms: float,
                  f_max: float | None) -> tuple[int, int, float]:
    n_fft = int(sample_rate * win_ms / 1000.0)
    hop = int(sample_rate * hop_ms / 1000.0)
    f_max = f_max if f_max is not None else sample_rate / 2 - 100.0
    return n_fft, hop, f_max


def _check_length(t: int, n_fft: int) -> None:
    if t <= n_fft // 2:
        raise ValueError(
            f"log-mel needs more than n_fft//2 = {n_fft // 2} samples for its "
            f"reflect pad, got {t}")


def _reflect_pad(y: torch.Tensor, pad: int) -> torch.Tensor:
    return torch.cat([y[1:pad + 1].flip(0), y, y[-pad - 1:-1].flip(0)])


def _log_mel_1d(y: torch.Tensor, sample_rate: int = 16000, n_mels: int = 80,
                win_ms: float = 25.0, hop_ms: float = 10.0, f_min: float = 20.0,
                f_max: float | None = None, eps: float = 1e-6) -> torch.Tensor:
    """Plain version of K2: [T] float32 -> [T//hop + 1, n_mels] log-mel via
    the blocked windowed DFT."""
    n_fft, hop, f_max = _frame_params(sample_rate, win_ms, hop_ms, f_max)
    _check_length(y.shape[0], n_fft)
    y = y.float()
    pad = n_fft // 2
    yp = _reflect_pad(y, pad)
    k = -(-n_fft // hop)
    t = yp.shape[0]
    n = (t - n_fft) // hop + 1
    nb = n + k - 1
    # padded samples only meet the zero rows of the block weights
    yp = torch.nn.functional.pad(yp, (0, max(0, nb * hop - t)))
    blocks = yp[:nb * hop].reshape(nb, hop)
    cw, sw = _windowed_dft(n_fft)
    cwp = np.zeros((k * hop, cw.shape[1]), np.float32)
    swp = np.zeros_like(cwp)
    cwp[:n_fft], swp[:n_fft] = cw, sw
    dev = y.device
    cwp = torch.from_numpy(cwp).to(dev)
    swp = torch.from_numpy(swp).to(dev)
    real = sum(blocks[j:j + n] @ cwp[j * hop:(j + 1) * hop] for j in range(k))
    imag = sum(blocks[j:j + n] @ swp[j * hop:(j + 1) * hop] for j in range(k))
    power = real * real + imag * imag
    fb = torch.from_numpy(
        _mel_filterbank_np(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate)
    ).to(dev)
    return torch.log(power @ fb + eps)


_KERNEL_CONSTS: dict = {}


def _kernel_constants(device, n_fft, n_mels, f_min, f_max, sample_rate):
    key = (str(device), n_fft, n_mels, f_min, f_max, sample_rate)
    if key not in _KERNEL_CONSTS:
        cw, sw = _windowed_dft(n_fft)
        fb = _mel_filterbank_np(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate)
        _KERNEL_CONSTS[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (cw, sw, fb))
    return _KERNEL_CONSTS[key]


def fused_log_mel(y: torch.Tensor, sample_rate: int = 16000, n_mels: int = 80,
                  win_ms: float = 25.0, hop_ms: float = 10.0,
                  f_min: float = 20.0, f_max: float | None = None,
                  eps: float = 1e-6) -> torch.Tensor:
    """K2: [T] float32 waveform -> [T//hop + 1, n_mels] log-mel, center=True
    reflect padding.  CPU tensor: the plain version.  CUDA tensor: one
    launch of ``csrc/fused_fbank.cu`` (reflect pad done in the kernel's
    staging loop), or an exception."""
    if y.ndim != 1:
        raise ValueError(f"expected a [T] waveform, got {tuple(y.shape)}")
    if y.device.type == "cpu":
        return _log_mel_1d(y, sample_rate, n_mels, win_ms, hop_ms, f_min,
                           f_max, eps)
    n_fft, hop, f_max = _frame_params(sample_rate, win_ms, hop_ms, f_max)
    t = y.shape[0]
    _check_length(t, n_fft)
    kernels.check_cuda_tensor(y, "fused_log_mel: y", torch.float32)
    n_bins = n_fft // 2 + 1
    if n_fft % 4 or hop % 4 or n_bins > 256 or n_mels > 256:
        raise ValueError(f"fused_log_mel kernel: unsupported geometry "
                         f"n_fft={n_fft} hop={hop} n_mels={n_mels}")
    cw, sw, fb = _kernel_constants(y.device, n_fft, n_mels, f_min, f_max,
                                   sample_rate)
    n_frames = t // hop + 1
    out = torch.empty((n_frames, n_mels), dtype=torch.float32, device=y.device)
    kernels.launch(
        "fused_log_mel", y.data_ptr(), t, cw.data_ptr(), sw.data_ptr(),
        fb.data_ptr(), n_fft, hop, n_bins, n_mels, float(eps), out.data_ptr(),
        n_frames, torch.cuda.current_stream(y.device).cuda_stream)
    return out

"""Log-mel filterbank features (25 ms Hann window, 10 ms hop, HTK mel scale,
no filterbank norm, ``log(x + 1e-6)``), on the tensor's device.

Holds kernel K2 and its plain version:

* :func:`_log_mel_1d` — the plain PyTorch version: the B==1 blocked
  windowed-DFT form of the JAX package (``dsp/mel.py::_log_mel_1d``), the
  form its main path ran.  Frame ``i`` spans ``k = ceil(n_fft/hop)`` hop
  blocks of the reflect-padded signal, so the DFT is ``k`` accumulated
  products over contiguous block slices.
* :func:`_log_mel_batched` — the plain PyTorch version for a batch
  [B, T]: the framed form of the JAX package (``log_mel_spectrogram``,
  B > 1), each row reflect-padded on its own.  :func:`log_mel_spectrogram`
  picks between the two as the JAX function does.
* :func:`fbank_batch` — K2 over a batch of utterances with per-utterance
  mean normalization: the per-window encoder's front end.
* :func:`fused_log_mel` — the wrapper of the CUDA kernel
  ``csrc/fused_fbank.cu`` (the port of the Pallas ``fused_log_mel``), for a
  waveform [T] or a batch [B, T] in one launch.  On a CPU tensor it returns
  the plain version; on a CUDA tensor it launches the kernel or raises.
* :func:`_folded_basis`, :func:`_tf32_split`, :func:`_basis_fragments`,
  :func:`_mel_sparse` — the kernel's constants: the basis after the
  even/odd fold of each frame that halves the DFT, split into TF32 parts
  for the three-product error-compensated scheme the kernel runs on the
  tensor cores, in the layout its matrix descriptors name; the filterbank
  without its zeros.

The reflect pad needs ``T > n_fft // 2`` samples; shorter inputs raise (the
JAX path clamps its pad without a word there).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import cost, kernels  # noqa: F401  (kernels: launches refused)


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


def mel_filterbank(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                   sample_rate: int, device=None) -> torch.Tensor:
    """Triangular HTK-scale mel filterbank [n_freqs, n_mels] float32 on
    ``device`` (the CPU by default)."""
    return torch.from_numpy(_mel_filterbank_np(
        n_freqs, f_min, f_max, n_mels, sample_rate).copy()).to(device)


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


def _log_mel_batched(y: torch.Tensor, sample_rate: int = 16000,
                     n_mels: int = 80, win_ms: float = 25.0,
                     hop_ms: float = 10.0, f_min: float = 20.0,
                     f_max: float | None = None, eps: float = 1e-6,
                     center: bool = True) -> torch.Tensor:
    """Plain version of K2 for a batch: [B, T] float32 ->
    [B, T//hop + 1, n_mels] log-mel.  Every row is reflect-padded by
    ``n_fft // 2`` on its own, framed, and contracted against the windowed
    DFT basis (the window folds into the contraction axis).  With
    ``center=False`` the rows are framed unpadded: [B, (T - n_fft)//hop + 1,
    n_mels], no frame past the end."""
    n_fft, hop, f_max = _frame_params(sample_rate, win_ms, hop_ms, f_max)
    y = y.float()
    if center:
        _check_length(y.shape[-1], n_fft)
        pad = n_fft // 2
        y = torch.cat([y[:, 1:pad + 1].flip(1), y, y[:, -pad - 1:-1].flip(1)], 1)
    elif y.shape[-1] < n_fft:
        raise ValueError(f"log-mel with center=False needs at least n_fft = "
                         f"{n_fft} samples, got {y.shape[-1]}")
    frames = y.unfold(-1, n_fft, hop)                      # [B, n, n_fft]
    cw, sw = (torch.from_numpy(a).to(y.device) for a in _windowed_dft(n_fft))
    real = frames @ cw
    imag = frames @ sw
    power = real * real + imag * imag
    fb = torch.from_numpy(
        _mel_filterbank_np(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate)
    ).to(y.device)
    return torch.log(power @ fb + eps)


def log_mel_spectrogram(y: torch.Tensor, sample_rate: int = 16000,
                        n_mels: int = 80, win_ms: float = 25.0,
                        hop_ms: float = 10.0, f_min: float = 20.0,
                        f_max: float | None = None, eps: float = 1e-6,
                        center: bool = True) -> torch.Tensor:
    """[T] or [B, T] waveforms -> [B, n_frames, n_mels] log-mel in plain
    PyTorch.  With ``center`` (reflect padding of ``n_fft // 2`` a side):
    the blocked form for one waveform, the framed form for a batch (the
    choice the JAX function makes); without it, the framed form unpadded."""
    if y.ndim == 1:
        y = y[None]
    args = (sample_rate, n_mels, win_ms, hop_ms, f_min, f_max, eps)
    if y.shape[0] == 1 and center:
        return _log_mel_1d(y[0], *args)[None]
    return _log_mel_batched(y, *args, center=center)


# geometry of the kernel's B operand (csrc/fused_fbank.cu): 8-tap slices;
# core matrices of 8 bins x 4 taps, 26 of them along the bins
_K_STEP, _K_CORE, _N_TILE, _N_TILES = 8, 4, 8, 26


@lru_cache(maxsize=8)
def _folded_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """The windowed DFT basis after the even/odd fold: two [n_fft//2, n_bins]
    matrices whose row ``j`` is tap ``j + 1``.  The window and the cosine
    basis are symmetric about tap ``n_fft//2`` and the sine basis is
    antisymmetric, so ``re = e @ ce`` and ``im = o @ so`` with
    ``e[n] = x[n] + x[n_fft-n]``, ``o[n] = x[n] - x[n_fft-n]`` (tap
    ``n_fft//2`` alone; tap 0 has window weight 0)."""
    cw, sw = _windowed_dft(n_fft)
    half = n_fft // 2
    if n_fft % 2 or cw[0].any() or sw[0].any():
        raise ValueError(f"the fold needs an even n_fft and a window that is "
                         f"0 at tap 0, got n_fft={n_fft}")
    ce = cw[1:half + 1].copy()
    so = sw[1:half + 1].copy()
    so[half - 1] = 0.0
    return ce, so


def _tf32_round(a: np.ndarray) -> np.ndarray:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero, as ``cvt.rna.tf32.f32``), still stored as float32."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``a ~= hi + lo`` with both parts TF32 values: the operands of the
    error-compensated three-product scheme."""
    hi = _tf32_round(a)
    return hi, _tf32_round(a.astype(np.float32) - hi)


def _basis_fragments(n_fft: int) -> np.ndarray:
    """The folded basis, split into TF32 hi and lo parts and laid out as the
    kernel's ``wgmma`` reads its B operand from shared memory (K-major, no
    swizzle): ``[k_step, part (cos, sin), hi | lo, tap half, bin tile, 8, 4]``
    float32, where entry ``[ks, p, h, kc, nt, r, c]`` is tap row
    ``8*ks + 4*kc + c`` and bin ``8*nt + r``: a core matrix of 8 bins x 4
    taps is 128 contiguous bytes, the next along the bins follows it, the
    next along the taps comes 26 core matrices later.  Taps are zero-padded
    to a multiple of 8 and bins to 208.  Returned as ``[k_step, -1]``: one
    row is one stage of the kernel's ring."""
    ce, so = _folded_basis(n_fft)
    half, n_bins = ce.shape
    n_ks = -(-half // _K_STEP)
    if n_bins > _N_TILE * _N_TILES:
        raise ValueError(f"fused_log_mel kernel: {n_bins} bins exceed "
                         f"{_N_TILE * _N_TILES}")
    out = np.zeros((n_ks, 2, 2, _K_STEP // _K_CORE, _N_TILES, _N_TILE, _K_CORE),
                   np.float32)
    for part, mat in enumerate((ce, so)):
        padded = np.zeros((n_ks * _K_STEP, _N_TILES * _N_TILE), np.float32)
        padded[:half, :n_bins] = mat
        for j, piece in enumerate(_tf32_split(padded)):
            # [k_step, tap half, c, tile, r] -> [k_step, tap half, tile, r, c]
            out[:, part, j] = piece.reshape(
                n_ks, _K_STEP // _K_CORE, _K_CORE, _N_TILES, _N_TILE
            ).transpose(0, 1, 3, 4, 2)
    return out.reshape(n_ks, -1)


def _mel_sparse(fb: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank [n_bins, n_mels] without its zeros, as the kernel
    reads it: ``idx`` int32 [3, n_mels] (first nonzero bin, one past the
    last, offset into ``w``) and ``w`` float32 [nnz], filter ``m``'s weights
    for bins ``idx[0, m] .. idx[1, m] - 1`` packed one filter after the
    other.  An all-zero filter gets an empty range."""
    nz = fb != 0
    some = nz.any(0)
    lo = np.where(some, nz.argmax(0), 0)
    hi = np.where(some, fb.shape[0] - nz[::-1].argmax(0), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    w = np.concatenate([fb[lo[m]:hi[m], m] for m in range(fb.shape[1])])
    return (np.stack([lo, hi, off]).astype(np.int32),
            np.ascontiguousarray(w, np.float32))


_KERNEL_CONSTS: dict = {}


def _kernel_constants(device, n_fft, n_mels, f_min, f_max, sample_rate):
    """Device constants of the kernel, made once per geometry: the split
    basis in core-matrix order and the packed mel filterbank."""
    key = (str(device), n_fft, n_mels, f_min, f_max, sample_rate)
    if key not in _KERNEL_CONSTS:
        fb = _mel_filterbank_np(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate)
        _KERNEL_CONSTS[key] = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (_basis_fragments(n_fft), *_mel_sparse(fb)))
    return _KERNEL_CONSTS[key]


def fused_log_mel(y: torch.Tensor, sample_rate: int = 16000, n_mels: int = 80,
                  win_ms: float = 25.0, hop_ms: float = 10.0,
                  f_min: float = 20.0, f_max: float | None = None,
                  eps: float = 1e-6) -> torch.Tensor:
    """K2: [T] float32 waveform -> [T//hop + 1, n_mels] log-mel, or a batch
    [B, T] -> [B, T//hop + 1, n_mels], center=True reflect padding of each
    row.  CPU tensor: the plain version.  CUDA tensor: ONE launch of
    ``csrc/fused_fbank.cu`` for the whole batch (reflect pad and fold done
    in the kernel's staging loops), or an exception.  The kernel has no
    backward: a waveform that requires grad while autograd records is
    refused (:func:`~..ops.kernels.refuse_autograd`); training passes data.

    A CUDA batch needs unit stride along the samples only: the kernel
    addresses rows by ``y.stride(0)``, so overlapping windows cut from one
    signal (``Tensor.unfold``) are read in place, without a contiguous
    copy."""
    if y.ndim not in (1, 2):
        raise ValueError(f"expected a [T] or [B, T] waveform, got "
                         f"{tuple(y.shape)}")
    if True:  # the reference: the plain float32 log-mel on every device
        out = log_mel_spectrogram(y, sample_rate, n_mels, win_ms, hop_ms,
                                  f_min, f_max, eps)
        return out[0] if y.ndim == 1 else out
    kernels.refuse_autograd("fused_log_mel", y)
    n_fft, hop, f_max = _frame_params(sample_rate, win_ms, hop_ms, f_max)
    t = y.shape[-1]
    _check_length(t, n_fft)
    if y.ndim == 1:
        kernels.check_cuda_tensor(y, "fused_log_mel: y", torch.float32)
        n_batch, row_stride = 1, t
    else:
        if y.dtype != torch.float32:
            raise TypeError(f"fused_log_mel: y: expected torch.float32, got "
                            f"{y.dtype}")
        n_batch, row_stride = y.shape[0], y.stride(0)
        if n_batch < 1 or y.stride(1) != 1 or row_stride < 0:
            raise ValueError(
                f"fused_log_mel: y: expected a non-empty batch with unit "
                f"stride along the samples, got shape {tuple(y.shape)} "
                f"strides {y.stride()}")
    # raises for an n_fft the fold or the kernel's 208 bins do not take; a
    # geometry too large for the kernel's shared memory fails the launch
    basis, mel_idx, mel_w = _kernel_constants(y.device, n_fft, n_mels, f_min,
                                              f_max, sample_rate)
    n_frames = t // hop + 1
    out = torch.empty((n_batch, n_frames, n_mels), dtype=torch.float32,
                      device=y.device)
    kernels.launch(
        "fused_log_mel", y.data_ptr(), n_batch, row_stride, t,
        basis.data_ptr(), basis.shape[0], mel_idx.data_ptr(),
        mel_w.data_ptr(), mel_w.numel(), n_fft, hop, n_mels, float(eps),
        out.data_ptr(), n_frames,
        torch.cuda.current_stream(y.device).cuda_stream, device=y.device,
        form="[T]" if y.ndim == 1 else "[B, T]",
        work=lambda: cost.fused_log_mel_work(
            n_batch * n_frames, n_mels,
            min(n_batch * t, (n_batch - 1) * row_stride + t), n_fft,
            sample_rate),
        shape=(f"[T] {n_mels} mels" if y.ndim == 1
               else f"[B, T] rows of {t} at a stride of {row_stride}, "
                    f"{n_mels} mels"))
    return out[0] if y.ndim == 1 else out


def fbank_batch(wavs: torch.Tensor, sample_rate: int = 16000, n_mels: int = 80,
                mean_norm: bool = True) -> torch.Tensor:
    """The per-utterance encoder's features: [B, T] waveforms -> [B, T//hop
    + 1, n_mels] log-mel (each row reflect-padded on its own), less each
    utterance's mean over its frames when ``mean_norm``.  One K2 launch on
    the card: the rows may be overlapping windows of one signal
    (``Tensor.unfold``), read in place by their stride."""
    feat = fused_log_mel(wavs, sample_rate=sample_rate, n_mels=n_mels)
    if mean_norm:
        feat = feat - feat.mean(dim=1, keepdim=True)
    return feat

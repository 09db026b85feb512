"""The card's peaks and the analytic work of the kernels.

The kernels are launched through ``ctypes`` (``ops/kernels.py``), so no
PyTorch counter sees their products.  :func:`asp_grid_work` and
:func:`fused_log_mel_work` count the work of the function each kernel
computes, from its shapes and with no padding of any implementation, so a
figure reads the same whatever computes it:

* ``flops``: the products as ``torch.utils.flop_counter`` counts them on a
  dense implementation (two operations per multiply-add of each matrix
  product; elementwise work is not counted).  ``utils/profiling.py::
  model_complexity`` adds it for every launch a run makes.
* ``bytes``: each input read once and each output written once.
* ``ops``: the least operations by type, the numerator of :func:`bound`.

The JAX package's ``asp_grid_flops`` counts otherwise: the Pallas kernel's
padded shapes (channels and attention width to 128, windows to its block)
and its elementwise work; see PERF.md.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM
# bytes/s and rates by operation type
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16_tensor": 989e12, "tf32_tensor": 495e12, "f32": 67e12,
              "f64": 33.5e12}


def bound(bytes_moved: float, ops: dict[str, float]) -> tuple[float, str]:
    """Least time (ms) for the work: the larger of bytes over the memory
    rate and, for each operation type, its count over that type's peak;
    with what bounds it ('bytes' or 'operations')."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = max(n / PEAK_FLOPS[k] for k, n in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def asp_grid_work(cc: int, a_dim: int, hop_f: int, win_f: int,
                  n_windows: int) -> dict:
    """K1 over ``n_windows`` windows of ``win_f`` rows at ``hop_f``, ``cc``
    channels, attention width ``a_dim`` (the net's, not a padded one)."""
    n_rows = (n_windows - 1) * hop_f + win_f
    # the shared pre-projection and the per-window logits
    products = 2 * n_rows * cc * a_dim + 2 * n_windows * win_f * a_dim * cc
    # bf16 features and weights, float32 window bias, BN, b2 and output
    nbytes = (2 * n_rows * cc + 4 * n_windows * a_dim + 2 * 2 * a_dim * cc
              + 4 * (2 * a_dim + cc) + 4 * n_windows * 2 * cc)
    # per (window, row, channel): bias, max, sub, exp, sum, p*x (2),
    # p*x^2 (3) = 10; per (window, row, a): bias, relu, BN fma, tanh = 5
    f32 = n_windows * win_f * (10 * cc + 5 * a_dim)
    return {"flops": products, "bytes": nbytes,
            "ops": {"bf16_tensor": products, "f32": f32}}


@lru_cache(maxsize=16)
def _filterbank_nonzeros(n_bins: int, n_mels: int, sample_rate: int) -> int:
    from ..dsp.mel import _mel_filterbank_np

    return int(np.count_nonzero(_mel_filterbank_np(
        n_bins, 20.0, sample_rate / 2 - 100.0, n_mels, sample_rate)))


def fused_log_mel_work(n_frames: int, n_mels: int, n_samples: int,
                       n_fft: int = 400, sample_rate: int = 16000) -> dict:
    """K2 producing ``n_frames`` frames of ``n_mels`` from ``n_samples``
    distinct input samples (rows of a strided view that overlap count
    once), at the diarizer's front end (f_min 20 Hz, f_max sr/2 - 100)."""
    n_bins = n_fft // 2 + 1
    products = n_frames * (4 * n_fft * n_bins + 2 * n_bins * n_mels)
    # waveform, the two windowed DFT bases, the filterbank, the output
    nbytes = 4 * (n_samples + 2 * n_fft * n_bins + n_bins * n_mels
                  + n_frames * n_mels)
    # the least operations: the even/odd fold about tap n_fft/2 (exact: the
    # window and the cosines are symmetric, the sines antisymmetric) leaves
    # n_fft/2 taps against the cosines and n_fft/2 - 1 against the sines.
    # A quiet band's log needs float32 accuracy, which the tensor cores give
    # as three TF32 products (3xTF32).  The fold, the power, the
    # filterbank's nonzero weights and the log at the float32 rate.
    dft = n_frames * (2 * (n_fft // 2) * n_bins + 2 * (n_fft // 2 - 1) * n_bins)
    fb_nnz = _filterbank_nonzeros(n_bins, n_mels, sample_rate)
    f32 = n_frames * (2 * (n_fft // 2 - 1) + 3 * n_bins + 2 * fb_nnz + 2 * n_mels)
    return {"flops": products, "bytes": nbytes,
            "ops": {"tf32_tensor": 3 * dft, "f32": f32}}


def resample_poly_work(n_ch: int, n_in: int, n_out: int, up: int, down: int) -> dict:
    """K3 resampling ``n_ch`` rows of ``n_in`` samples to ``n_out`` by
    ``up / down``: every output sums, in float64, the taps of scipy's
    ``2 * 10 * max(up, down) + 1``-tap filter that fall on input samples
    (about ``len(h) / up`` of them; the zero extension at either end adds
    none), two operations a tap."""
    n_taps = 20 * max(up, down) + 1
    products = 2 * n_ch * n_out * n_taps // up
    nbytes = 4 * n_ch * (n_in + n_out) + 8 * up * -(-n_taps // up)
    return {"flops": products, "bytes": nbytes, "ops": {"f64": products}}

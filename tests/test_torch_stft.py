"""The port's STFT, iSTFT and overlap-add against the JAX package's
``dsp/stft.py`` and ``dsp/ola.py`` on the same numpy-seeded inputs.

Bars: windows equal to float32 rounding (atol 1e-7); spectra within 1e-5 of
their peak (float32 matrix products of 512 terms); waveforms from the
inverse within 1e-6 of their peak; overlap-add within 1e-6 (the same sums,
in another order only where three or more frames meet); a round trip
restores the input to 1e-5 of its peak.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.dsp.ola import ola_normalization as jola_norm
from speech_diarization_tpu.dsp.ola import overlap_add as joverlap_add
from speech_diarization_tpu.dsp.stft import hann_window as jhann
from speech_diarization_tpu.dsp.stft import istft_ri as jistft_ri
from speech_diarization_tpu.dsp.stft import sqrt_hann_window as jsqrt_hann
from speech_diarization_tpu.dsp.stft import stft_ri as jstft_ri
from speech_diarization_tpu_torch.dsp.ola import ola_normalization, overlap_add
from speech_diarization_tpu_torch.dsp.stft import (
    hann_window,
    istft_ri,
    sqrt_hann_window,
    stft_ri,
)

torch.set_num_threads(2)


def _wave(shape, seed=0):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("n,periodic", [(512, True), (512, False), (400, True),
                                        (5 * 16000, False)])
def test_windows_match(n, periodic):
    np.testing.assert_allclose(hann_window(n, periodic).numpy(),
                               np.asarray(jhann(n, periodic)), atol=1e-7)
    np.testing.assert_allclose(sqrt_hann_window(n, periodic).numpy(),
                               np.asarray(jsqrt_hann(n, periodic)), atol=1e-7)


# (shape, n_fft, hop): one waveform, a batch, a length off the hop grid,
# and another transform size
STFT_CASES = [((16000,), 512, 256), ((3, 8000), 512, 256),
              ((2, 8000 + 37), 512, 256), ((4001,), 400, 160)]


@pytest.mark.parametrize("shape,n_fft,hop", STFT_CASES)
def test_stft_ri_matches(shape, n_fft, hop):
    y = _wave(shape)
    ref = np.asarray(jstft_ri(jnp.asarray(y), n_fft, hop))
    out = stft_ri(torch.from_numpy(y), n_fft, hop).numpy()
    assert out.shape == ref.shape == (*shape[:-1], n_fft // 2 + 1,
                                      1 + shape[-1] // hop, 2)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("shape,n_fft,hop", STFT_CASES)
def test_istft_ri_matches(shape, n_fft, hop):
    spec = np.asarray(jstft_ri(jnp.asarray(_wave(shape, 1)), n_fft, hop))
    spec = spec * (1.0 + 0.1 * _wave(spec.shape, 2))        # not a clean STFT
    length = shape[-1] - 5
    ref = np.asarray(jistft_ri(jnp.asarray(spec), n_fft, hop, length=length))
    out = istft_ri(torch.from_numpy(spec), n_fft, hop, length=length).numpy()
    assert out.shape == ref.shape == (*shape[:-1], length)
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("shape", [(16000,), (2, 16000 + 100)])
def test_round_trip(shape):
    y = _wave(shape, 3)
    back = istft_ri(stft_ri(torch.from_numpy(y)), length=shape[-1]).numpy()
    assert np.abs(back - y).max() <= 1e-5 * np.abs(y).max()
    jback = np.asarray(jistft_ri(jstft_ri(jnp.asarray(y)), length=shape[-1]))
    assert np.abs(back - jback).max() <= 1e-6 * np.abs(y).max()


def test_istft_without_length_trims_the_centre_pad():
    spec = stft_ri(torch.from_numpy(_wave((8192,), 4)))
    ref = np.asarray(jistft_ri(jnp.asarray(spec.numpy())))
    out = istft_ri(spec).numpy()
    assert out.shape == ref.shape == (8192,)
    assert np.abs(out - ref).max() <= 1e-6 * np.abs(ref).max()


# (frames shape, hop): hop dividing the frame, not dividing it (the chunk
# OLA of the enhancer: 4 s chunks at a 3 s stride), a stride longer than
# the frame, and a single frame
OLA_CASES = [((2, 7, 512), 256), ((3, 64000), 48000), ((5, 100), 37),
             ((1, 9, 50), 60), ((1, 1, 30), 7)]


@pytest.mark.parametrize("shape,hop", OLA_CASES)
def test_overlap_add_matches(shape, hop):
    f = _wave(shape, 5)
    ref = np.asarray(joverlap_add(jnp.asarray(f), hop))
    out = overlap_add(torch.from_numpy(f), hop).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("n,win,hop,windowed", [(7, 512, 256, True),
                                                (2, 64000, 48000, True),
                                                (5, 100, 37, False),
                                                (3, 50, 60, False)])
def test_ola_normalization_matches(n, win, hop, windowed):
    """A Hann window, or ones (the JAX function's default)."""
    w = hann_window(win, periodic=False) if windowed else None
    jw = jhann(win, periodic=False) if windowed else None
    np.testing.assert_allclose(ola_normalization(n, win, hop, w).numpy(),
                               np.asarray(jola_norm(n, win, hop, jw)), atol=1e-7)

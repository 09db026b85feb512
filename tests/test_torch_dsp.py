"""The PyTorch port's DSP front against the JAX package.

Inputs come from numpy seeds.  Bars: log-mel atol 2e-3 (the fused-fbank bar
of tests/test_pallas_fbank.py); framing and pre-emphasis 1e-6; loudness
0.01 LU against the exact IIR meter of the JAX package (the port's FIR
K-weighting truncates the impulse response at 2048 taps).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.dsp.framing import frame_signal as jframe
from speech_diarization_tpu.dsp.framing import num_frames as jnum_frames
from speech_diarization_tpu.dsp.loudness import integrated_loudness as jlufs
from speech_diarization_tpu.dsp.mel import _mel_filterbank_np as jfb
from speech_diarization_tpu.dsp.mel import log_mel_spectrogram as jlog_mel
from speech_diarization_tpu.dsp.preprocess import preemphasis as jpreemph
from speech_diarization_tpu.ops.pallas.fused_fbank import fused_log_mel as jfused
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu_torch.dsp.framing import frame_signal, num_frames
from speech_diarization_tpu_torch.dsp.loudness import integrated_loudness
from speech_diarization_tpu_torch.dsp.mel import (
    _log_mel_1d,
    _mel_filterbank_np,
    fused_log_mel,
)
from speech_diarization_tpu_torch.dsp.preprocess import preemphasis

torch.set_num_threads(2)
SR = 16000


def _speech(dur_s: float, seed: int) -> np.ndarray:
    w, _ = make_conversation(np.random.default_rng(seed), dur_s, n_speakers=2, sr=SR)
    return w.astype(np.float32)


@pytest.mark.parametrize("n_samples,n_mels", [(16000, 40), (48000, 40),
                                              (40123, 80), (3 * 16000 + 7, 40)])
def test_log_mel_matches_jax_single_waveform_path(n_samples, n_mels):
    y = (0.3 * np.random.default_rng(n_samples).standard_normal(n_samples)
         ).astype(np.float32)
    ref = np.asarray(jlog_mel(jnp.asarray(y)[None], sample_rate=SR,
                              n_mels=n_mels))[0]
    out = fused_log_mel(torch.from_numpy(y), sample_rate=SR, n_mels=n_mels).numpy()
    assert out.shape == ref.shape == (n_samples // 160 + 1, n_mels)
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_log_mel_matches_pallas_fused_kernel_interpret(seed):
    y = _speech(3.0, seed)
    ref = np.asarray(jfused(jnp.asarray(y), sample_rate=SR, n_mels=40,
                            tile_n=64, interpret=True))
    out = _log_mel_1d(torch.from_numpy(y), sample_rate=SR, n_mels=40).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=2e-3)


@pytest.mark.parametrize("t", [10, 200])
def test_log_mel_refuses_inputs_too_short_for_the_reflect_pad(t):
    with pytest.raises(ValueError):
        fused_log_mel(torch.zeros(t), n_mels=40)


@pytest.mark.parametrize("n_mels,f_max", [(40, 7900.0), (80, 7900.0), (64, 8000.0)])
def test_mel_filterbank_equal(n_mels, f_max):
    np.testing.assert_array_equal(_mel_filterbank_np(201, 20.0, f_max, n_mels, SR),
                                  jfb(201, 20.0, f_max, n_mels, SR))


@pytest.mark.parametrize("coef", [0.97, 0.5])
def test_preemphasis_matches_jax(coef):
    y = np.random.default_rng(5).standard_normal(4001).astype(np.float32)
    ref = np.asarray(jpreemph(jnp.asarray(y), coef))
    out = preemphasis(torch.from_numpy(y), coef).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("t,win,hop,pad_tail", [
    (1000, 400, 160, True), (1000, 400, 160, False), (80000, 5 * SR // 2, 800, False),
    (300, 400, 160, True), (160 * 20, 160, 160, True)])
def test_frame_signal_matches_jax(t, win, hop, pad_tail):
    y = np.random.default_rng(t).standard_normal((2, t)).astype(np.float32)
    ref = np.asarray(jframe(jnp.asarray(y), win, hop, pad_tail=pad_tail))
    out = frame_signal(torch.from_numpy(y), win, hop, pad_tail=pad_tail).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert num_frames(t, win, hop, pad_tail) == jnum_frames(t, win, hop, pad_tail)


@pytest.mark.parametrize("case", ["speech", "quiet", "silence", "short"])
def test_chunk_loudness_matches_jax(case):
    if case == "silence":
        y = np.zeros(SR * 2, np.float32)
    elif case == "short":
        y = (0.1 * np.random.default_rng(2).standard_normal(SR // 4)).astype(np.float32)
    else:
        y = _speech(6.0, 7) * (0.01 if case == "quiet" else 1.0)
    ref = float(jlufs(jnp.asarray(y), SR))
    out = float(integrated_loudness(torch.from_numpy(y), SR))
    if case == "silence":
        assert out == ref == -200.0
    else:
        assert abs(out - ref) < 0.01, (out, ref)

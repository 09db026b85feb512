"""The port's binding to the native audio runtime (``native/audioio.cpp``)
against the JAX package's binding, scipy and numpy, and ``read_audio`` of
non-16 kHz WAVs against the JAX ``read_audio``.

Bars: the two bindings build the same source with the same flags, so the
resampler agrees exactly (both packages then read a 8 kHz or 44.1 kHz mono
WAV to the same waveform, ROADMAP F12); against scipy's float64 filter
atol 5e-4 (``tests/test_native.py``'s bar); decode and framing exact.
"""
from __future__ import annotations

import logging

import numpy as np
import pytest

from speech_diarization_tpu import native as jnative
from speech_diarization_tpu.io.audio import read_audio as jread_audio
from speech_diarization_tpu_torch import native
from speech_diarization_tpu_torch.dsp.resample import resample_host
from speech_diarization_tpu_torch.io.audio import read_audio, write_wav


@pytest.fixture(scope="module", autouse=True)
def both_built():
    assert native.available(), native.build_error()
    if not jnative.available():
        pytest.skip("the JAX package's native library does not build here")


def test_the_library_is_the_ports_own_build():
    path = native._lib_path()
    assert path.parent == native.BUILD and path.exists()
    assert "speech_diarization_tpu_torch" in str(path)


@pytest.mark.parametrize("orig,target", [(44100, 16000), (8000, 16000),
                                         (48000, 16000), (16000, 44100)])
def test_resample_matches_the_jax_binding_and_scipy(orig, target):
    y = (np.random.default_rng(0).standard_normal(orig) * 0.3).astype(np.float32)
    out = native.resample_poly(y, orig, target)
    np.testing.assert_array_equal(out, jnative.resample_poly(y, orig, target))
    ref = resample_host(y, orig, target)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=5e-4)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_decode_pcm_matches_the_jax_binding(width):
    raw = np.random.default_rng(width).integers(0, 256, 6 * 999, np.uint8).tobytes()
    np.testing.assert_array_equal(native.decode_pcm(raw, 2, width),
                                  jnative.decode_pcm(raw, 2, width))


def test_framing_matches_the_jax_binding():
    y = np.random.default_rng(1).standard_normal(5000).astype(np.float32)
    np.testing.assert_array_equal(native.frame(y, 480, 160),
                                  jnative.frame(y, 480, 160))
    np.testing.assert_array_equal(native.frame_rms_db(y, 400, 160),
                                  jnative.frame_rms_db(y, 400, 160))


@pytest.mark.parametrize("sr", [8000, 44100])
def test_read_audio_matches_the_jax_package_off_16_khz(tmp_path, sr):
    t = np.arange(int(1.5 * sr)) / sr
    y = (0.4 * np.sin(2 * np.pi * 440.0 * t)
         + 0.05 * np.random.default_rng(sr).standard_normal(t.size))
    wav = tmp_path / f"x{sr}.wav"
    write_wav(wav, y.astype(np.float32), sr)
    out, out_sr = read_audio(wav, target_sr=16000)
    ref, ref_sr = jread_audio(wav, target_sr=16000)
    assert out_sr == ref_sr == 16000
    np.testing.assert_array_equal(out, ref)


def test_a_failed_build_warns_with_the_compilers_error(tmp_path, monkeypatch):
    """A source g++ cannot compile: no library, a warning quoting g++, and
    the scipy fallback (the same filter) for the resampler."""
    bad = tmp_path / "audioio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    native.log.addHandler(handler)
    try:
        assert not native.available()
    finally:
        native.log.removeHandler(handler)
    assert "g++" in native.build_error()
    assert any("native audio runtime unavailable" in r.getMessage()
               and "g++" in r.getMessage() for r in records)
    y = np.random.default_rng(2).standard_normal(8000).astype(np.float32)
    np.testing.assert_array_equal(native.resample_poly(y, 8000, 16000),
                                  resample_host(y, 8000, 16000))

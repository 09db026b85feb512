"""The port's non-WAV decode chain (``io/audio.py``: soundfile, then ffmpeg
with ffprobe, then ``RuntimeError``) against the JAX package's
``read_audio`` on the same stubs: neither soundfile nor ffmpeg is
installed here, so stub executables on ``PATH`` (``shutil.which`` patched,
as tests/test_metrics.py does) and a stub ``soundfile`` module stand in.

Bars: the decoded arrays equal the JAX package's exactly (same bytes, same
host arithmetic); the error is the same type and message; the CLI's RTTM
of a stub-decoded ``.flac`` equals the ``.wav`` run's line for line.
"""
from __future__ import annotations

import shutil
import sys
import types

import numpy as np
import pytest
import torch

from speech_diarization_tpu.io.audio import read_audio as jread_audio
from speech_diarization_tpu_torch import cli
from speech_diarization_tpu_torch.io.audio import read_audio, read_wav, write_wav
from speech_diarization_tpu_torch.train.synthetic import make_conversation

torch.set_num_threads(4)

_FFMPEG = """#!/usr/bin/env python3
import sys, numpy as np
args = sys.argv[1:]
with open({log!r}, "a") as f:
    f.write(" ".join(args) + "\\n")
ac = int(args[args.index('-ac') + 1])
sr = int(args[args.index('-ar') + 1])
t = np.arange(sr // 10) / sr
ch = [np.sin(2 * np.pi * 440.0 * (k + 1) * t).astype(np.float32) * 0.5
      for k in range(2)]
out = ch[0] if ac == 1 else np.stack(ch[:ac], axis=1).ravel()
sys.stdout.buffer.write(out.astype('<f4').tobytes())
"""


def _tools(tmp_path, monkeypatch, probe: str | None):
    """Stub ffmpeg (a 0.1 s sine per channel at the rate it is asked for)
    and, unless ``probe`` is None, an ffprobe running ``probe`` (shell)."""
    log = tmp_path / "ffmpeg.log"
    (tmp_path / "ffmpeg").write_text(_FFMPEG.format(log=str(log)))
    names = {"ffmpeg"}
    if probe is not None:
        (tmp_path / "ffprobe").write_text("#!/bin/sh\n" + probe + "\n")
        names.add("ffprobe")
    for n in names:
        (tmp_path / n).chmod(0o755)
    monkeypatch.setitem(sys.modules, "soundfile", None)   # import fails
    monkeypatch.setattr(shutil, "which",
                        lambda name: str(tmp_path / name) if name in names else None)
    return log


def _both(path, **kw):
    return read_audio(path, **kw), jread_audio(path, **kw)


@pytest.mark.parametrize("mono,target_sr", [(False, None), (True, None),
                                            (True, 16000)])
def test_ffmpeg_stereo_equals_the_jax_package(tmp_path, monkeypatch, mono,
                                              target_sr):
    """ffprobe says 8 kHz stereo: ffmpeg is asked for 2 channels, the
    interleaved stream is deinterleaved (not flattened into double-length
    mono), then mixed and resampled as asked."""
    log = _tools(tmp_path, monkeypatch, "echo 8000,2")
    (p, sr), (j, jsr) = _both(tmp_path / "x.mp3", target_sr=target_sr, mono=mono)
    assert sr == jsr == (target_sr or 8000)
    assert p.dtype == np.float32 and p.shape == j.shape
    assert p.shape == ((800 * (target_sr or 8000) // 8000,) if mono else (2, 800))
    np.testing.assert_array_equal(p, j)
    assert all("-ac 2" in line and "-ar 8000" in line
               for line in log.read_text().splitlines())


@pytest.mark.parametrize("probe", [None, "exit 1", "echo"])
def test_ffmpeg_without_a_channel_count_forces_mono(tmp_path, monkeypatch, probe):
    """No ffprobe, a failing one or an empty answer: 16 kHz and ``-ac 1``,
    the probe's error swallowed, as in the JAX package."""
    log = _tools(tmp_path, monkeypatch, probe)
    (p, sr), (j, jsr) = _both(tmp_path / "x.flac", target_sr=None, mono=False)
    assert sr == jsr == 16000 and p.shape == j.shape == (1, 1600)
    np.testing.assert_array_equal(p, j)
    assert all("-ac 1" in line and "-ar 16000" in line
               for line in log.read_text().splitlines())


def test_soundfile_comes_first(tmp_path, monkeypatch):
    """A soundfile that imports decodes before ffmpeg is looked for."""
    data = np.random.default_rng(0).standard_normal((480, 2)) * 0.1
    stub = types.ModuleType("soundfile")
    stub.read = lambda path, always_2d: (data, 48000)
    monkeypatch.setitem(sys.modules, "soundfile", stub)
    monkeypatch.setattr(shutil, "which", lambda name: pytest.fail(
        "ffmpeg looked for although soundfile decoded"))
    for kw in ({"target_sr": None, "mono": False}, {"target_sr": 16000}):
        (p, sr), (j, jsr) = _both(tmp_path / "x.ogg", **kw)
        assert sr == jsr and p.shape == j.shape
        np.testing.assert_array_equal(p, j)


def test_no_decoder_raises_the_jax_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError) as port_err:
        read_audio(tmp_path / "x.m4a")
    with pytest.raises(RuntimeError) as jax_err:
        jread_audio(tmp_path / "x.m4a")
    assert str(port_err.value) == str(jax_err.value)
    assert "cannot decode .m4a" in str(port_err.value)


def test_cli_diarize_on_a_stub_decoded_flac_equals_the_wav_run(tmp_path,
                                                               monkeypatch):
    """The CLI's ``diarize`` (its defaults, on the CPU) on ``x.flac``
    decoded by the stub ffmpeg gives the RTTM of the same samples read
    from ``x.wav``."""
    wave, _ = make_conversation(np.random.default_rng(5), 12.0, n_speakers=2)
    wav = tmp_path / "wav" / "x.wav"
    write_wav(wav, wave, 16000)
    pcm, _ = read_wav(wav)                     # what the WAV run reads
    raw = tmp_path / "x.f32"
    raw.write_bytes(pcm[0].astype("<f4").tobytes())
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "ffmpeg").write_text(f"#!/bin/sh\ncat {raw}\n")
    (bin_dir / "ffprobe").write_text("#!/bin/sh\necho 16000,1\n")
    for n in ("ffmpeg", "ffprobe"):
        (bin_dir / n).chmod(0o755)
    flac = tmp_path / "flac" / "x.flac"
    flac.parent.mkdir()
    flac.write_bytes(b"fLaC")                  # only the stubs read it
    monkeypatch.setitem(sys.modules, "soundfile", None)
    monkeypatch.setattr(shutil, "which",
                        lambda name: str(bin_dir / name)
                        if name in ("ffmpeg", "ffprobe") else None)
    rttm = {}
    for kind, path in (("wav", wav), ("flac", flac)):
        out = tmp_path / f"out_{kind}"
        assert cli.main(["diarize", str(path), "--cpu", "--out-dir", str(out),
                         "--format", "rttm"]) == 0
        rttm[kind] = (out / "x.rttm").read_text().splitlines()
    assert rttm["wav"] and rttm["flac"] == rttm["wav"]

"""Host-side audio I/O: decode, mono mix and polyphase resampling (mono
input through the native resampler when it builds, as in the JAX package;
else scipy's, the same filter).

WAV (PCM 8/16/24/32) is decoded with numpy.  Other containers (flac, mp3,
ogg, m4a, ...) go through ``soundfile`` when it imports, else an ``ffmpeg``
subprocess when one is on ``PATH`` (``ffprobe`` reads the rate and channel
count), else :func:`read_audio` raises ``RuntimeError``: the JAX package's
order and error.
"""
from __future__ import annotations

import shutil
import subprocess
import wave
from pathlib import Path

import numpy as np

from ..dsp.resample import resample_host


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a PCM WAV file -> (float32 [C, T], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # PCM32 (the wave module does not expose the format tag)
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        signed = (
            a[:, 0].astype(np.int32)
            | (a[:, 1].astype(np.int32) << 8)
            | (a[:, 2].astype(np.int32) << 16)
        )
        signed = np.where(signed >= 1 << 23, signed - (1 << 24), signed)
        data = signed.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:  # pragma: no cover
        raise ValueError(f"unsupported WAV sample width: {width}")
    return data.reshape(-1, n_ch).T, sr


def write_wav(path: str | Path, y: np.ndarray, sr: int) -> None:
    """Write float32 [T] or [C, T] audio as 16-bit PCM WAV."""
    y = np.asarray(y)
    if y.ndim == 1:
        y = y[None, :]
    pcm = np.clip(y.T, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(y.shape[0])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def _read_soundfile(path: Path) -> tuple[np.ndarray, int] | None:
    try:
        import soundfile as sf  # optional dependency
    except ImportError:
        return None
    data, sr = sf.read(str(path), always_2d=True)
    return data.astype(np.float32).T, sr


def _read_ffmpeg(path: Path) -> tuple[np.ndarray, int] | None:
    """Decode through ``ffmpeg`` as interleaved float32.  The rate and the
    channel count come from ``ffprobe``; when it is absent or fails, the
    rate is 16 kHz and ffmpeg downmixes to mono (``-ac 1``), since a raw
    stream of unknown width cannot be deinterleaved (the JAX package's
    rule)."""
    ffmpeg = shutil.which("ffmpeg")
    ffprobe = shutil.which("ffprobe")
    if not ffmpeg:
        return None
    sr, n_ch = 16000, None
    if ffprobe:
        try:
            out = subprocess.run(
                [ffprobe, "-v", "quiet", "-select_streams", "a:0",
                 "-show_entries", "stream=sample_rate,channels",
                 "-of", "csv=p=0", str(path)],
                capture_output=True, text=True, check=True,
            ).stdout.strip()
            fields = out.splitlines()[0].split(",")
            sr = int(fields[0])
            if len(fields) > 1:
                n_ch = int(fields[1])
        except (OSError, subprocess.SubprocessError, IndexError, ValueError):
            # an unreadable probe leaves the defaults, as in the JAX package
            pass
    ac = ["-ac", str(n_ch)] if n_ch else ["-ac", "1"]
    proc = subprocess.run(
        [ffmpeg, "-v", "quiet", "-i", str(path), "-f", "f32le",
         "-acodec", "pcm_f32le", "-ar", str(sr), *ac, "-"],
        capture_output=True, check=True,
    )
    data = np.frombuffer(proc.stdout, dtype="<f4")
    ch = n_ch or 1
    data = data[: (len(data) // ch) * ch]
    return np.ascontiguousarray(data.reshape(-1, ch).T), sr


def read_audio(
    source: str | Path | tuple[np.ndarray, int],
    target_sr: int | None = 16000,
    mono: bool = True,
) -> tuple[np.ndarray, int]:
    """Load audio from a path or an (array, sr) pair; optionally mono-mix
    and resample.  Returns (float32 [T] if mono else [C, T], sr).  Arrays may
    be [T], [C, T] or [T, C]."""
    if isinstance(source, tuple):
        y, sr = source
        y = np.asarray(y, dtype=np.float32)
        if y.ndim == 2 and y.shape[0] > y.shape[1]:
            y = y.T  # [T, C] -> [C, T]
        if y.ndim == 1:
            y = y[None, :]
    else:
        path = Path(source)
        if path.suffix.lower() == ".wav":
            y, sr = read_wav(path)
        else:
            got = _read_soundfile(path) or _read_ffmpeg(path)
            if got is None:
                raise RuntimeError(
                    f"cannot decode {path.suffix} (no soundfile/ffmpeg available); "
                    "convert to WAV first"
                )
            y, sr = got
    if mono and y.shape[0] > 1:
        y = y.mean(axis=0, keepdims=True)
    if target_sr is not None and sr != target_sr:
        from .. import native

        if mono and native.available():
            # the OpenMP polyphase resampler (native/audioio.cpp), the same
            # filter; the JAX package's order
            y = native.resample_poly(y[0], sr, target_sr)[None, :]
        else:
            y = resample_host(y, sr, target_sr)
        sr = target_sr
    if mono:
        y = y[0]
    return np.ascontiguousarray(y, dtype=np.float32), sr

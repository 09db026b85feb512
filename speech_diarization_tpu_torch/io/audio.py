"""Host-side audio I/O: WAV decode, mono mix and polyphase resampling
(mono input through the native resampler when it builds, as in the JAX
package; else scipy's, the same filter).

WAV (PCM 8/16/24/32) is decoded with numpy; other containers are not read by
this package yet (convert to WAV first).
"""
from __future__ import annotations

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


def read_audio(
    source: str | Path | tuple[np.ndarray, int],
    target_sr: int | None = 16000,
    mono: bool = True,
) -> tuple[np.ndarray, int]:
    """Load audio from a WAV path or an (array, sr) pair; optionally mono-mix
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
        if path.suffix.lower() != ".wav":
            raise NotImplementedError(
                f"cannot decode {path.suffix}: this package reads WAV only; "
                "convert to WAV first")
        y, sr = read_wav(path)
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

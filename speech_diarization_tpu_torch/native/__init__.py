"""ctypes binding of the port to the native audio runtime
(``native/audioio.cpp`` at the repository root): OpenMP PCM decode,
polyphase resampling, framing and a frame-RMS prescan on the host.

The library is built with ``g++`` at first use into ``build/`` beside this
package (git-ignored), under a name that carries a hash of the source, so
an edited source is rebuilt and a stale library is never loaded; the port
never writes or loads another package's build of it.  When the build fails
a warning quotes the compiler's error, :func:`available` is False, and
every entry point falls back to numpy / scipy (the resampler to
:func:`~..dsp.resample.resample_host`, the same filter).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from math import gcd
from pathlib import Path

import numpy as np

from ..utils.logging import get_logger

log = get_logger("native")

SRC = Path(__file__).resolve().parents[2] / "native" / "audioio.cpp"
BUILD = Path(__file__).resolve().parents[1] / "build"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:12]
    return BUILD / f"libsdtpu_audioio_{digest}.so"


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = _lib_path()
            if not path.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", str(SRC),
                     "-o", str(tmp)], capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ exit {proc.returncode}: "
                                       f"{(proc.stderr or proc.stdout).strip()}")
                os.replace(tmp, path)
            lib = ctypes.CDLL(str(path))
            for fn in ("sdtpu_decode_pcm", "sdtpu_resample_poly", "sdtpu_frame",
                       "sdtpu_frame_rms_db", "sdtpu_num_threads"):
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
        except Exception as e:  # noqa: BLE001 - reported, then numpy/scipy
            _build_error = f"{type(e).__name__}: {e}"
            log.warning("native audio runtime unavailable (numpy/scipy "
                        "fallbacks in use): %s", _build_error)
    return _lib


def available() -> bool:
    """True when the library is built and loaded."""
    return _load() is not None


def build_error() -> str | None:
    """Why the library is unavailable (the compiler's error), or None."""
    _load()
    return _build_error


def num_threads() -> int:
    lib = _load()
    return int(lib.sdtpu_num_threads()) if lib else 1


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def decode_pcm(raw: bytes, channels: int, width: int) -> np.ndarray:
    """Interleaved PCM bytes (8/16/24/32-bit) -> float32 mono [T]."""
    n_frames = len(raw) // (channels * width)
    buf = np.frombuffer(raw, dtype=np.uint8)[:n_frames * channels * width]
    lib = _load()
    if lib is None:
        if width == 2:
            data = buf.view("<i2").astype(np.float32) / 32768.0
        elif width == 4:
            data = buf.view("<i4").astype(np.float32) / 2147483648.0
        elif width == 1:
            data = (buf.astype(np.float32) - 128.0) / 128.0
        else:
            a = buf.reshape(-1, 3)
            x = (a[:, 0].astype(np.int32) | (a[:, 1].astype(np.int32) << 8)
                 | (a[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x)
            data = x.astype(np.float32) / float(1 << 23)
        return data.reshape(-1, channels).mean(axis=1).astype(np.float32)
    out = np.empty(n_frames, dtype=np.float32)
    rc = lib.sdtpu_decode_pcm(_ptr(np.ascontiguousarray(buf)),
                              ctypes.c_int64(n_frames), ctypes.c_int(channels),
                              ctypes.c_int(width), _ptr(out))
    if rc != 0:
        raise RuntimeError(f"sdtpu_decode_pcm failed: {rc}")
    return out


def resample_poly(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling of a mono [T] signal with scipy's default
    Kaiser filter (float32 taps), multi-threaded; float32 out."""
    from ..dsp.resample import _poly_filter, resample_host

    if orig_sr == target_sr:
        return np.asarray(y, dtype=np.float32)
    lib = _load()
    if lib is None:
        return resample_host(y, orig_sr, target_sr)
    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    h = _poly_filter(up, down).astype(np.float32)
    x = np.ascontiguousarray(y, dtype=np.float32)
    ny = -(-x.shape[-1] * up // down)
    out = np.empty(ny, dtype=np.float32)
    rc = lib.sdtpu_resample_poly(_ptr(x), ctypes.c_int64(x.shape[-1]), _ptr(h),
                                 ctypes.c_int(len(h)), ctypes.c_int(up),
                                 ctypes.c_int(down), _ptr(out), ctypes.c_int64(ny))
    if rc != 0:
        raise RuntimeError(f"sdtpu_resample_poly failed: {rc}")
    return out


def frame(y: np.ndarray, win: int, hop: int) -> np.ndarray:
    """Dense [n_frames, win] framing with the tail zero-padded."""
    from ..dsp.framing import num_frames

    x = np.ascontiguousarray(y, dtype=np.float32)
    n = num_frames(x.shape[-1], win, hop, pad_tail=True)
    lib = _load()
    if lib is None:
        out = np.zeros((n, win), dtype=np.float32)
        for f in range(n):
            seg = x[f * hop:f * hop + win]
            out[f, :len(seg)] = seg
        return out
    out = np.empty((n, win), dtype=np.float32)
    rc = lib.sdtpu_frame(_ptr(x), ctypes.c_int64(x.shape[-1]), ctypes.c_int(win),
                         ctypes.c_int(hop), _ptr(out), ctypes.c_int64(n))
    if rc != 0:
        raise RuntimeError(f"sdtpu_frame failed: {rc}")
    return out


def frame_rms_db(y: np.ndarray, win: int, hop: int) -> np.ndarray:
    """Per-frame RMS in dB, ``10 log10(mean(x^2) + 1e-10)``."""
    from ..dsp.framing import num_frames

    x = np.ascontiguousarray(y, dtype=np.float32)
    n = num_frames(x.shape[-1], win, hop, pad_tail=True)
    lib = _load()
    if lib is None:
        fr = frame(x, win, hop)
        return (10.0 * np.log10(np.mean(fr * fr, axis=1) + 1e-10)).astype(np.float32)
    out = np.empty(n, dtype=np.float32)
    rc = lib.sdtpu_frame_rms_db(_ptr(x), ctypes.c_int64(x.shape[-1]),
                                ctypes.c_int(win), ctypes.c_int(hop),
                                _ptr(out), ctypes.c_int64(n))
    if rc != 0:
        raise RuntimeError(f"sdtpu_frame_rms_db failed: {rc}")
    return out

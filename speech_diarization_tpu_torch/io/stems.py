"""Per-speaker stem extraction with fades and length-capped tracks.

The JAX package's ``io/stems.py``, a mirror of ``extract_speaker_stems``
(``diarization_baseline.py:42-160``):
per speaker, concatenate that speaker's chunks in time order with inter-chunk
silence capped at ``max_gap_s``, apply linear fade-in/out per chunk, split the
running track whenever adding the next chunk would exceed ``max_segment_s``,
and drop tracks shorter than ``min_stem_s``.  Output files are
``<root>/<speaker>/<stem>-NNN.wav`` (16-bit PCM; FLAC when soundfile is
available).
"""
from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np

from ..types import SegmentArray
from .audio import write_wav


def _linear_fade(chunk: np.ndarray, fade_samples: int) -> np.ndarray:
    if fade_samples <= 0 or chunk.shape[-1] < 2 * fade_samples:
        return chunk
    out = chunk.copy()
    ramp = np.linspace(0.0, 1.0, fade_samples, dtype=chunk.dtype)
    out[..., :fade_samples] *= ramp
    out[..., -fade_samples:] *= ramp[::-1]
    return out


def _save(path: Path, chunks: list[np.ndarray], sr: int) -> Path:
    track = np.concatenate(chunks, axis=-1)
    try:
        import soundfile as sf

        path = path.with_suffix(".flac")
        path.parent.mkdir(parents=True, exist_ok=True)
        sf.write(str(path), track.T if track.ndim == 2 else track, sr,
                 subtype="PCM_16")
    except ImportError:
        path = path.with_suffix(".wav")
        write_wav(path, track, sr)
    return path


def extract_speaker_stems(
    y: np.ndarray,
    sr: int,
    segs: SegmentArray,
    root: str | Path,
    max_segment_s: float = 20.0,
    max_gap_s: float = 1.5,
    fade_ms: float = 20.0,
    min_stem_s: float = 3.0,
    stem_name: str = "audio",
) -> dict[int, list[str]]:
    """Export per-speaker audio tracks.  ``y`` is [T] or [C, T]."""
    y = np.asarray(y, dtype=np.float32)
    if y.ndim == 1:
        y = y[None, :]
    root = Path(root)
    fade = int(round(fade_ms / 1000.0 * sr))

    by_spk: dict[int, list[tuple[float, float]]] = defaultdict(list)
    for s, e, k in zip(segs.starts, segs.ends, segs.spks):
        if k >= 0:
            by_spk[int(k)].append((float(s), float(e)))

    outputs: dict[int, list[str]] = defaultdict(list)
    for spk, spans in by_spk.items():
        spans.sort()
        chunks: list[np.ndarray] = []
        duration = 0.0
        last_end = 0.0

        def flush():
            nonlocal chunks, duration
            if chunks and duration >= min_stem_s:
                out = root / str(spk) / f"{stem_name}-{len(outputs[spk]):03d}"
                written = _save(out, chunks, sr)
                outputs[spk].append(str(written))
            chunks, duration = [], 0.0

        for i, (s, e) in enumerate(spans):
            speech_dur = e - s
            gap = min(s - last_end, max_gap_s) if i > 0 else 0.0
            if duration > 0 and duration + gap + speech_dur > max_segment_s:
                flush()
                gap = 0.0
            if gap > 0:
                chunks.append(np.zeros((y.shape[0], int(gap * sr)), np.float32))
                duration += gap
            chunk = y[:, int(s * sr) : int(e * sr)]
            chunks.append(_linear_fade(chunk, fade))
            duration += speech_dur
            last_end = e
        flush()
    return dict(outputs)

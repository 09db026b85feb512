"""The end-to-end arithmetic, over every file the window completed."""
from __future__ import annotations

import math

import numpy as np


def rtf(audio_s: list[float], t0: float, t_done: list[float]) -> float:
    """Audio seconds of all completed files over the wall from the window's
    start ``t0`` to the last completion."""
    if not audio_s:
        raise ValueError("no file completed")
    return float(sum(audio_s) / (max(t_done) - t0))


def p95(walls: list[float]) -> float:
    """The 95th percentile of all walls: the nearest rank, ceil(0.95 n)."""
    if not walls:
        raise ValueError("no file completed")
    v = sorted(walls)
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


def mean_der(pool, done, shift_truth) -> float | None:
    """Mean DER of the completed files against the generator's truth,
    shifted as each file was (for reading; ``correct`` does not use it)."""
    if not done:
        return None
    from ..reference.metrics.der import diarization_error_rate
    from ..reference.types import SegmentArray

    ders = []
    for f in done:
        n = pool[f.draw].wave.shape[-1]
        s, e, k = shift_truth(pool[f.draw].truth, f.offset, n)
        seg = f.result.segments
        ders.append(diarization_error_rate(
            SegmentArray(s, e, k),
            SegmentArray(np.asarray(seg.starts), np.asarray(seg.ends),
                         np.asarray(seg.spks))).der)
    return float(np.mean(ders))

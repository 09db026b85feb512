"""Speaker-change detection over the shared embedding grid.

Behavior mirror of ``scd_split_segments`` (``anti_stick_diarize.py:78-127``):
inside each VAD segment, z-score the consecutive-window cosine distances, pick
peaks above a threshold, and cut the segment at peak midpoints with a
minimum-turn guard.

All window embeddings come from the single dense grid computed once per
file, so SCD costs one [W-1] row of dot products, on the host.
"""
from __future__ import annotations

import numpy as np

from ..ops.peaks import find_peaks_zscore
from ..types import SegmentArray


def consecutive_cosine_distance(win_embs: np.ndarray) -> np.ndarray:
    """[W, D] -> [W-1] distances 1 - cos(e_i, e_{i+1})."""
    if win_embs.shape[0] < 2:
        return np.zeros((0,), dtype=np.float32)
    e = win_embs / (np.linalg.norm(win_embs, axis=1, keepdims=True) + 1e-8)
    sims = np.einsum("id,id->i", e[:-1], e[1:])
    return (1.0 - sims).astype(np.float32)


def scd_split(
    segs: SegmentArray,
    win_embs: np.ndarray,
    win_starts_s: np.ndarray,
    win_s: float,
    hop_s: float,
    z_threshold: float = 1.5,
    min_speech_s: float = 1.0,
) -> SegmentArray:
    """Split segments at speaker-change peaks.

    Args:
        segs: VAD speech segments.
        win_embs: [W, D] grid embeddings at (win_s, hop_s).
        win_starts_s: [W] window start times.
    """
    if len(segs) == 0 or win_embs.shape[0] < 3:
        return segs

    dists_all = consecutive_cosine_distance(win_embs)
    centers = win_starts_s + win_s / 2.0  # window centers

    out_starts: list[float] = []
    out_ends: list[float] = []
    for s, e in zip(segs.starts, segs.ends):
        # windows fully inside the segment
        inside = np.where((win_starts_s >= s) & (win_starts_s + win_s <= e))[0]
        if inside.size < 3:
            out_starts.append(s)
            out_ends.append(e)
            continue
        # consecutive distances among those windows, on the host: a device
        # call per segment would cost a host<->device round trip each
        d = dists_all[inside[0] : inside[-1]]
        peaks = np.where(find_peaks_zscore(d, z_threshold)[0])[0]
        if peaks.size == 0:
            out_starts.append(s)
            out_ends.append(e)
            continue
        # cut at the midpoint between the two windows flanking each peak
        cuts = sorted(
            set(
                float(0.5 * (centers[inside[0] + p] + centers[inside[0] + p + 1]))
                for p in peaks
            )
        )
        last = s
        for cut in cuts:
            if cut - last >= min_speech_s and e - cut > 0:
                out_starts.append(last)
                out_ends.append(cut)
                last = cut
        if e - last >= min_speech_s or last == s:
            out_starts.append(last)
            out_ends.append(e)
    return SegmentArray(np.array(out_starts), np.array(out_ends))

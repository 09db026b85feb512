"""Segment merging and boundary ops (vectorized/host interval algebra).

Mirrors (and fixes) the reference's merge family:
  * ``merge_adjacent`` — ``anti_stick_diarize.py:464-475``
  * ``conservative_merge`` — ``anti_stick_diarize.py:273-330``; note the
    reference call site passes the *label array* where embeddings are expected
    (``anti_stick_diarize.py:540-546``, SURVEY.md §2.5 item 1) — we implement
    the intended embedding-gated merge.
  * the batch diarizer's ``merge_same_speaker``, ``adjust_segment_boundaries``
    and ``filter_short_segments`` (``diarization_baseline.py:188-233``).
"""
from __future__ import annotations

import numpy as np

from ..types import SegmentArray


def merge_adjacent(segs: SegmentArray, gap_s: float = 0.05) -> SegmentArray:
    """Merge time-adjacent segments with the same speaker when the gap is
    within ``gap_s``."""
    n = len(segs)
    if n <= 1:
        return segs
    starts, ends, spks = [segs.starts[0]], [segs.ends[0]], [segs.spks[0]]
    for s, e, k in zip(segs.starts[1:], segs.ends[1:], segs.spks[1:]):
        if k == spks[-1] and (s - ends[-1]) <= gap_s:
            ends[-1] = e
        else:
            starts.append(s)
            ends.append(e)
            spks.append(k)
    return SegmentArray(np.array(starts), np.array(ends), np.array(spks))


def conservative_merge(
    segs: SegmentArray,
    embs: np.ndarray,
    max_gap_s: float = 0.5,
    max_turn_s: float = 30.0,
    min_cos: float = 0.80,
) -> tuple[SegmentArray, np.ndarray]:
    """Same-speaker merge gated by gap, turn length AND running-embedding
    cosine similarity; the merged embedding is the normalized sum.

    Returns (merged segments, merged embeddings) — downstream stages reuse the
    embeddings instead of re-encoding (the reference re-embeds after merging,
    ``anti_stick_diarize.py:547``).
    """
    n = len(segs)
    if n == 0:
        return segs, embs
    order = np.lexsort((segs.ends, segs.starts))
    starts, ends, spks = segs.starts[order], segs.ends[order], segs.spks[order]
    embs = np.asarray(embs, dtype=np.float32)[order]

    m_start = [starts[0]]
    m_end = [ends[0]]
    m_spk = [spks[0]]
    m_emb = [embs[0]]
    for i in range(1, n):
        gap_ok = starts[i] - m_end[-1] <= max_gap_s
        turn_ok = ends[i] - m_start[-1] <= max_turn_s
        if spks[i] == m_spk[-1] and gap_ok and turn_ok:
            a = m_emb[-1] / (np.linalg.norm(m_emb[-1]) + 1e-8)
            b = embs[i] / (np.linalg.norm(embs[i]) + 1e-8)
            if float(a @ b) >= min_cos:
                m_end[-1] = ends[i]
                merged = m_emb[-1] + embs[i]
                m_emb[-1] = merged / (np.linalg.norm(merged) + 1e-8)
                continue
        m_start.append(starts[i])
        m_end.append(ends[i])
        m_spk.append(spks[i])
        m_emb.append(embs[i])
    return (
        SegmentArray(np.array(m_start), np.array(m_end), np.array(m_spk)),
        np.stack(m_emb),
    )


def merge_same_speaker(
    segs: SegmentArray, max_gap_s: float, max_segment_s: float
) -> SegmentArray:
    """Baseline-flavor merge: same speaker, gap <= max_gap_s, and the current
    run not already >= max_segment_s (``diarization_baseline.py:188-213``)."""
    n = len(segs)
    if n == 0:
        return segs
    starts, ends, spks = [segs.starts[0]], [segs.ends[0]], [segs.spks[0]]
    for s, e, k in zip(segs.starts[1:], segs.ends[1:], segs.spks[1:]):
        cur_len = ends[-1] - starts[-1]
        gap = s - ends[-1]
        if cur_len >= max_segment_s or k != spks[-1] or gap > max_gap_s:
            starts.append(s)
            ends.append(e)
            spks.append(k)
        else:
            ends[-1] = max(ends[-1], e)
    return SegmentArray(np.array(starts), np.array(ends), np.array(spks))


def adjust_segment_boundaries(segs: SegmentArray, padding_s: float) -> SegmentArray:
    """Extend boundaries into silence gaps that are at least ``padding_s``
    wide (``diarization_baseline.py:216-233``): the earlier segment gains
    ``padding_s`` at its end, the later one starts ``padding_s`` earlier."""
    n = len(segs)
    if n < 2:
        return segs
    starts = segs.starts.copy()
    ends = segs.ends.copy()
    gaps = starts[1:] - ends[:-1]
    wide = gaps >= padding_s
    ends[:-1] = np.where(wide, ends[:-1] + padding_s, ends[:-1])
    starts[1:] = np.where(wide, np.maximum(starts[1:] - padding_s, 0.0), starts[1:])
    return SegmentArray(starts, ends, segs.spks.copy())


def filter_short_segments(segs: SegmentArray, min_duration_s: float) -> SegmentArray:
    """Drop segments shorter than ``min_duration_s``
    (``diarization_baseline.py:299-300``)."""
    keep = segs.durations >= min_duration_s
    return SegmentArray(segs.starts[keep], segs.ends[keep], segs.spks[keep])

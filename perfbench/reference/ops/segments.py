"""Mask ↔ segment conversion (vectorized interval algebra).

Replaces ``mask_to_segments`` (``vad.py:90-163``): boolean VAD mask →
[start, end] second pairs with minimum-duration filtering, gap merging and
boundary padding.  The edge-detection/filter/merge math is vectorized numpy on
a [T]-bool array that has already been reduced on device — at 10 ms hop a
1-hour file is 360k bools (0.36 MB), so the transfer is negligible and the
host pass is O(#edges).  :func:`segments_to_mask` goes the other way, and
:func:`labels_to_segments` turns a label sequence into labeled segments.
"""
from __future__ import annotations

import numpy as np

from ..types import SegmentArray


def mask_edges(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Frame indices where runs of True start/end (end exclusive)."""
    padded = np.pad(mask.astype(np.int8), 1)
    diff = np.diff(padded)
    return np.where(diff == 1)[0], np.where(diff == -1)[0]


def mask_to_segments_host(
    mask: np.ndarray,
    hop_ms: float,
    min_speech_ms: float = 250.0,
    min_gap_ms: float = 100.0,
    speech_pad_ms: float = 40.0,
) -> SegmentArray:
    """Boolean mask -> padded speech segments, the post-VAD chain of
    ``vad.py:90-163``: (1) drop runs shorter than ``min_speech_ms``;
    (2) merge runs separated by gaps <= ``min_gap_ms``; (3) pad each merged
    run by ``speech_pad_ms`` clamped to the timeline."""
    mask = np.asarray(mask, dtype=bool)
    if not mask.any():
        return SegmentArray.from_pairs([])
    hop_s = hop_ms / 1000.0
    starts, ends = mask_edges(mask)

    keep = (ends - starts) >= round(min_speech_ms / hop_ms)
    starts, ends = starts[keep], ends[keep]
    if starts.size == 0:
        return SegmentArray.from_pairs([])

    # merge adjacent runs when the silence between them is small: a "new
    # segment" begins wherever the gap to the previous run exceeds the limit
    gap_frames = round(min_gap_ms / hop_ms)
    new_seg = np.empty(starts.size, dtype=bool)
    new_seg[0] = True
    new_seg[1:] = (starts[1:] - ends[:-1]) > gap_frames
    group = np.cumsum(new_seg) - 1
    n_groups = group[-1] + 1
    g_start = np.full(n_groups, np.iinfo(np.int64).max)
    g_end = np.zeros(n_groups, dtype=np.int64)
    np.minimum.at(g_start, group, starts)
    np.maximum.at(g_end, group, ends)

    pad = round(speech_pad_ms / hop_ms)
    g_start = np.maximum(g_start - pad, 0)
    g_end = np.minimum(g_end + pad, mask.shape[0])
    return SegmentArray(
        np.round(g_start * hop_s, 3), np.round(g_end * hop_s, 3)
    )


def segments_to_mask(segs: SegmentArray, n_frames: int, hop_s: float) -> np.ndarray:
    """Rasterize segments back to a [n_frames] bool mask at resolution
    ``hop_s`` (the speech-mask rasterization of
    ``anti_stick_diarize.py:352-360``)."""
    mask = np.zeros(n_frames, dtype=bool)
    for s, e in zip(segs.starts, segs.ends):
        i0 = int(s / hop_s)
        i1 = int(e / hop_s)
        mask[max(i0, 0):min(i1, n_frames)] = True
    return mask


def labels_to_segments(window_starts_s: np.ndarray, labels: np.ndarray,
                       end_time_s: float) -> SegmentArray:
    """Frame/window labels -> labeled segments via change-point detection
    (the vectorized diff at ``anti_stick_diarize.py:370-386``).  ``labels``
    uses -1 for non-speech; those spans are dropped."""
    labels = np.asarray(labels)
    n = labels.shape[0]
    if n == 0:
        return SegmentArray.from_pairs([])
    change = np.empty(n, dtype=bool)
    change[0] = True
    change[1:] = labels[1:] != labels[:-1]
    cps = np.where(change)[0]
    seg_ends_idx = np.append(cps[1:], n)

    starts, ends, spks = [], [], []
    for s_idx, e_idx in zip(cps, seg_ends_idx):
        lab = int(labels[s_idx])
        if lab < 0:
            continue
        s_t = float(window_starts_s[s_idx])
        e_t = float(window_starts_s[e_idx]) if e_idx < n else end_time_s
        if e_t > s_t:
            starts.append(s_t)
            ends.append(e_t)
            spks.append(lab)
    return SegmentArray(np.array(starts), np.array(ends),
                        np.array(spks, dtype=np.int32))

"""Frame-level reassignment (resegmentation) over the shared embedding grid.

Behavior mirror of ``frame_reassign`` (``anti_stick_diarize.py:390-460``):
slide 1 s windows at 100 ms step over all VAD speech, assign each window to
the nearest speaker centroid by cosine, convert the label sequence back to
segments via change-point detection, and merge 50 ms adjacencies.

Window embeddings come from the dense grid computed once per file; the
windows-to-centroids similarity is one host matmul over the grid the packed
copy already brought back; an optional sticky-HMM Viterbi
(``ops/viterbi.py``) smooths the window labels.  Host-side numpy throughout.
"""
from __future__ import annotations

import numpy as np

from ..ops.segments import labels_to_segments, segments_to_mask
from ..ops.viterbi import sticky_transition_logits, viterbi_decode
from ..types import SegmentArray
from .merge import merge_adjacent


def speaker_centroids(
    segs: SegmentArray, embs: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """L2-normalized per-speaker mean embeddings.

    Returns (spk_ids [K], centroids [K, D]); noise (-1) segments are excluded
    (``speaker_centroids``, ``anti_stick_diarize.py:333-349``).
    """
    embs = np.asarray(embs)
    valid = segs.spks >= 0
    spk_ids = np.unique(segs.spks[valid])
    if spk_ids.size == 0:
        return np.zeros((0,), np.int32), np.zeros((0, embs.shape[1] if embs.size else 1), np.float32)
    cents = []
    for sid in spk_ids:
        m = embs[segs.spks == sid].mean(axis=0)
        cents.append(m / (np.linalg.norm(m) + 1e-8))
    return spk_ids.astype(np.int32), np.stack(cents).astype(np.float32)


def frame_reassign(
    speech_mask_segs: SegmentArray,  # original VAD speech regions
    labeled_segs: SegmentArray,      # clustered+merged segments
    seg_embs: np.ndarray,            # embeddings for labeled_segs
    win_embs: np.ndarray,            # [W, D] dense grid embeddings
    win_starts_s: np.ndarray,        # [W]
    win_s: float,
    total_duration_s: float,
    hmm: bool = False,
    hmm_self_loop: float = 0.995,
    adjacent_gap_s: float = 0.05,
) -> SegmentArray:
    if len(labeled_segs) == 0 or seg_embs.size == 0 or win_embs.shape[0] == 0:
        return labeled_segs

    spk_ids, cents = speaker_centroids(labeled_segs, seg_embs)
    if cents.shape[0] == 0:
        return labeled_segs

    # restrict to windows whose center lies inside VAD speech (10 ms raster,
    # the reference's resolution at anti_stick_diarize.py:352-367)
    hop_res = 0.01
    n_frames = int(np.ceil(total_duration_s / hop_res))
    smask = segments_to_mask(speech_mask_segs, n_frames, hop_res)
    centers = win_starts_s + win_s / 2.0
    center_frames = np.clip((centers / hop_res).astype(int), 0, n_frames - 1)
    valid = smask[center_frames]

    # [W, D] @ [D, K] on the host: a few MFLOP on embeddings that already
    # live in host memory
    e = win_embs / (np.linalg.norm(win_embs, axis=1, keepdims=True) + 1e-8)
    scores = e @ cents.T  # [W, K]
    if hmm and cents.shape[0] > 1:
        log_a = sticky_transition_logits(cents.shape[0], hmm_self_loop)
        best = viterbi_decode(scores, log_a)
    else:
        best = np.argmax(scores, axis=1)
    labels = np.where(valid, spk_ids[best], -1)

    # A window's label describes its CENTER: window i spans
    # [center - hop/2, center + hop/2) in the output timeline (labeling by
    # start time would bias every boundary left by win/2).
    hop_s = float(win_starts_s[1] - win_starts_s[0]) if len(win_starts_s) > 1 else win_s
    bounds = np.clip(centers - hop_s / 2.0, 0.0, total_duration_s)
    end_time = float(min(total_duration_s, centers[-1] + hop_s / 2.0))
    refined = labels_to_segments(bounds, labels, end_time)
    return merge_adjacent(refined, adjacent_gap_s)

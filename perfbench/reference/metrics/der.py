"""Diarization Error Rate (DER) with optimal speaker mapping and collar.

The reference publishes no DER and contains no metric code (SURVEY.md §6);
BASELINE.md makes DER-within-0.5 the accuracy contract, so the framework
ships its own reference implementation: frame-based scoring at a fixed
resolution with a NIST-style forgiveness collar around reference boundaries
and Hungarian optimal speaker mapping (the standard md-eval semantics).
:func:`jaccard_error_rate` is the DIHARD companion metric (JER).  A copy of
the JAX package's ``metrics/der.py`` (host numpy and scipy).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.optimize import linear_sum_assignment

from ..types import SegmentArray


@dataclass(frozen=True)
class DerBreakdown:
    der: float
    miss: float
    false_alarm: float
    confusion: float
    total_speech_s: float

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"DER {self.der * 100:.2f}% (miss {self.miss * 100:.2f}%, "
            f"fa {self.false_alarm * 100:.2f}%, conf {self.confusion * 100:.2f}%)"
        )


def _rasterize(segs: SegmentArray, n: int, res: float, k: int) -> np.ndarray:
    """[K, n] boolean speaker-activity raster."""
    grid = np.zeros((k, n), dtype=bool)
    for s, e, spk in zip(segs.starts, segs.ends, segs.spks):
        if spk < 0:
            continue
        i0, i1 = int(round(s / res)), int(round(e / res))
        grid[int(spk), max(i0, 0) : min(i1, n)] = True
    return grid


def diarization_error_rate(
    reference: SegmentArray,
    hypothesis: SegmentArray,
    collar_s: float = 0.25,
    resolution_s: float = 0.01,
    skip_overlap: bool = False,
) -> DerBreakdown:
    """Frame-based DER = (miss + false alarm + confusion) / reference speech.

    ``collar_s`` frames within +-collar of any reference boundary are excluded
    from scoring (md-eval convention).
    """
    end = max(
        float(reference.ends.max(initial=0.0)),
        float(hypothesis.ends.max(initial=0.0)),
        resolution_s,
    )
    n = int(np.ceil(end / resolution_s)) + 1
    k_ref = int(reference.spks.max(initial=-1)) + 1
    k_hyp = int(hypothesis.spks.max(initial=-1)) + 1
    ref = _rasterize(reference, n, resolution_s, max(k_ref, 1))
    hyp = _rasterize(hypothesis, n, resolution_s, max(k_hyp, 1))

    score_mask = np.ones(n, dtype=bool)
    if collar_s > 0:
        c = int(round(collar_s / resolution_s))
        for t in np.concatenate([reference.starts, reference.ends]):
            i = int(round(t / resolution_s))
            score_mask[max(0, i - c) : min(n, i + c)] = False
    if skip_overlap:
        score_mask &= ref.sum(axis=0) <= 1

    ref = ref[:, score_mask]
    hyp = hyp[:, score_mask]

    # optimal speaker mapping by overlap (Hungarian)
    overlap = (ref[:, None, :] & hyp[None, :, :]).sum(axis=2).astype(np.float64)
    r_idx, h_idx = linear_sum_assignment(-overlap)

    n_frames = ref.shape[1]
    ref_count = ref.sum(axis=0)  # speakers active per frame
    hyp_count = hyp.sum(axis=0)

    matched = np.zeros(n_frames, dtype=np.int64)
    for r, h in zip(r_idx, h_idx):
        matched += (ref[r] & hyp[h]).astype(np.int64)

    total_ref = int(ref_count.sum())
    miss = int(np.maximum(ref_count - hyp_count, 0).sum())
    fa = int(np.maximum(hyp_count - ref_count, 0).sum())
    confusion = int((np.minimum(ref_count, hyp_count) - matched).clip(0).sum())

    denom = max(total_ref, 1)
    return DerBreakdown(
        der=(miss + fa + confusion) / denom,
        miss=miss / denom,
        false_alarm=fa / denom,
        confusion=confusion / denom,
        total_speech_s=total_ref * resolution_s,
    )


def jaccard_error_rate(
    reference: SegmentArray,
    hypothesis: SegmentArray,
    collar_s: float = 0.0,
    resolution_s: float = 0.01,
) -> float:
    """JER: mean over reference speakers of 1 - |ref ∩ hyp| / |ref ∪ hyp|
    after optimal (Hungarian) speaker mapping — the DIHARD companion metric."""
    end = max(
        float(reference.ends.max(initial=0.0)),
        float(hypothesis.ends.max(initial=0.0)),
        resolution_s,
    )
    n = int(np.ceil(end / resolution_s)) + 1
    k_ref = max(int(reference.spks.max(initial=-1)) + 1, 1)
    k_hyp = max(int(hypothesis.spks.max(initial=-1)) + 1, 1)
    ref = _rasterize(reference, n, resolution_s, k_ref)
    hyp = _rasterize(hypothesis, n, resolution_s, k_hyp)

    if collar_s > 0:
        mask = np.ones(n, dtype=bool)
        c = int(round(collar_s / resolution_s))
        for t in np.concatenate([reference.starts, reference.ends]):
            i = int(round(t / resolution_s))
            mask[max(0, i - c) : min(n, i + c)] = False
        ref, hyp = ref[:, mask], hyp[:, mask]

    overlap = (ref[:, None, :] & hyp[None, :, :]).sum(axis=2).astype(np.float64)
    r_idx, h_idx = linear_sum_assignment(-overlap)
    mapping = dict(zip(r_idx, h_idx))

    errors = []
    for r in range(k_ref):
        if not ref[r].any():
            continue
        if r in mapping:
            h = hyp[mapping[r]]
            inter = (ref[r] & h).sum()
            union = (ref[r] | h).sum()
            errors.append(1.0 - inter / max(union, 1))
        else:
            errors.append(1.0)
    return float(np.mean(errors)) if errors else 0.0

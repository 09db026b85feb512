"""Spectral clustering with a sharpened weighted affinity, host numpy.

Cosine affinity -> ``max(cos, 0)^p + eps`` edge weights (p = ``_SHARPEN_P``)
-> symmetric normalized Laplacian -> the lowest eigenpairs -> eigengap
speaker count -> weighted k-means over the spectral embedding.  This is the
JAX package's numpy mirror ``_spectral_labels_np`` — the path its main path
ran on the TPU — not its jitted CPU path.  The power suppresses moderate
cross-speaker similarity without destroying its ordering; the ``eps`` floor
keeps outlier rows weakly connected (an isolated node would fake one extra
"speaker").  :func:`estimate_num_speakers` is the same eigengap rule on
a tensor of eigenvalues (the JAX package's public helper).
"""
from __future__ import annotations

import numpy as np
import torch

from .kmeans import kmeans

_SHARPEN_P = 3.0   # affinity sharpening power
_EDGE_EPS = 1e-4   # weak-connectivity floor


def estimate_num_speakers(eigvals: torch.Tensor, min_speakers: int,
                          max_speakers: int) -> torch.Tensor:
    """Eigengap heuristic on ascending normalized-Laplacian eigenvalues:
    ``k = argmax(lambda_{i+1} - lambda_i)`` over the allowed range, as a 0-d
    int32 tensor."""
    kmax = min(max_speakers, eigvals.shape[0] - 1)
    gaps = eigvals[1:kmax + 1] - eigvals[:kmax]     # gap i -> k = i+1 clusters
    idx = torch.arange(1, kmax + 1, device=eigvals.device)
    allowed = (idx >= min_speakers) & (idx <= max_speakers)
    gaps = torch.where(allowed, gaps, torch.full_like(gaps, -float("inf")))
    return (torch.argmax(gaps) + 1).to(torch.int32)


def _spectral_labels_np(
    embs: np.ndarray, weights: np.ndarray, min_speakers: int, max_speakers: int,
) -> np.ndarray:
    e = embs / (np.linalg.norm(embs, axis=1, keepdims=True) + 1e-8)
    aff = e @ e.T
    n = aff.shape[0]
    np.fill_diagonal(aff, 1.0)
    kmax = min(max_speakers, n - 1)
    idx_k = np.arange(1, kmax + 1)
    allowed = (idx_k >= min_speakers) & (idx_k <= max_speakers)

    a = np.maximum(aff, 0.0) ** _SHARPEN_P + _EDGE_EPS
    np.fill_diagonal(a, 1.0)
    a = 0.5 * (a + a.T)

    deg = a.sum(axis=1)
    dsq = 1.0 / np.sqrt(np.maximum(deg, 1e-8))
    lap = np.eye(n) - (dsq[:, None] * a) * dsq[None, :]
    # only the lowest kmax+1 eigenpairs matter (eigengap + k coordinates)
    from scipy.linalg import eigh as _scipy_eigh

    eigvals, spec_vecs = _scipy_eigh(lap, subset_by_index=[0, kmax])
    gaps = np.where(allowed, eigvals[1 : kmax + 1] - eigvals[:kmax], -np.inf)
    k = int(np.argmax(gaps)) + 1

    spec = spec_vecs[:, :k]
    spec = spec / (np.linalg.norm(spec, axis=1, keepdims=True) + 1e-9)
    labels, _ = kmeans(spec, k, iters=25, sample_weight=weights)
    return labels


# sub-centroid similarity above this = one speaker.  Calibrated for the
# 2 s grid-window geometry (the default): merged pairs measure
# 0.555-0.682, singles 0.724-0.940 (see refine_labels_by_windows docstring);
# per-encoder npz meta `refine_sub_cos` overrides.
_SPLIT_MAX_CENT_COS = 0.70
# bisection statistics are only trustworthy with enough fully-inside windows;
# at the 2 s / 0.1 s grid a 60 s file's merged pair yields ~43 — require 40
# (~6 s of on-grid speech per cluster beyond the window span).
_SPLIT_MIN_WINDOWS = 40


def bisect_windows(wemb: np.ndarray):
    """Cosine 2-means bisection of row-normalized window embeddings [M, D].

    Returns ``(sub_cos, side)``: the cosine between the two sub-centroids
    and the boolean side assignment.  Initialized by the sign of the top
    principal direction, refined by 10 cosine 2-means iterations.
    """
    centered = wemb - wemb.mean(0, keepdims=True)
    try:
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
    except np.linalg.LinAlgError:  # pragma: no cover - degenerate
        return 1.0, np.zeros(len(wemb), bool)
    side = centered @ vt[0] >= 0
    if side.sum() < 2 or (~side).sum() < 2:
        return 1.0, side
    c0 = c1 = None
    for _ in range(10):
        c0 = wemb[side].mean(0)
        c1 = wemb[~side].mean(0)
        c0 /= np.linalg.norm(c0) + 1e-9
        c1 /= np.linalg.norm(c1) + 1e-9
        new_side = wemb @ c0 >= wemb @ c1
        if new_side.sum() < 2 or (~new_side).sum() < 2 or (new_side == side).all():
            break
        side = new_side
    return float(c0 @ c1), side


def refine_labels_by_windows(
    labels: np.ndarray,          # [S] cluster label per segment
    segs,                        # SegmentArray (starts/ends in seconds)
    win_embs: np.ndarray,        # [W, D] dense-grid window embeddings
    win_starts_s: np.ndarray,    # [W]
    win_s: float,
    max_speakers: int,
    sub_cos_thr: float = _SPLIT_MAX_CENT_COS,
    min_windows: int = _SPLIT_MIN_WINDOWS,
    seg_embs: np.ndarray | None = None,
    polish_iters: int = 2,
) -> np.ndarray:
    """Recursive cluster bisection driven by WINDOW embeddings.

    Why: the global two-means affinity threshold can leave a
    moderately-similar speaker pair (cross-centroid cosine ~0.5-0.6)
    connected, so the eigengap sees one block — measured collapse on 2/6
    600 s synthetic files whose truth centroids were separable (cos 0.57)
    while within-speaker similarity is ~0.85+.  The decision runs on the
    dense grid windows, not segment embeddings: window statistics separate
    cleanly (measured sub-centroid cosine <= 0.60 for true merged pairs vs
    >= 0.77 for single speakers, at 60 s and 600 s alike) where few-segment
    clusters are too noisy and over-split.  Stopping rule mirrors the
    reference's agglomerative threshold semantics
    (``diarization_baseline.py:176-181``).  Each member segment follows the
    majority side of its own windows, so segments stay atomic.

    At 2 s grid windows the sub-centroid cosine bands separate: true merged
    pairs measure 0.555-0.682, true singles 0.724-0.940, so the absolute
    threshold (0.70, overridden per encoder by the checkpoint's
    ``refine_sub_cos`` meta) splits every merged pair of the JAX package's
    probe set (STATUS.md).

    Side assignment: when ``seg_embs`` is given, each member segment joins
    the sub-centroid its own pooled embedding is closer to (measured
    strictly better than per-segment window-majority, which leaves 13%
    confusion on the 600 s near-pair case — short segments have few or no
    fully-inside windows).  ``polish_iters`` runs a duration-weighted
    cosine k-means over segment embeddings after any split — it repairs
    straggler segments against the post-split centroids (seed-2000:
    2.38% -> 0.00% confusion) and is a no-op when labels are stable.
    """
    labels = np.asarray(labels, np.int32).copy()
    if len(labels) == 0 or win_embs.shape[0] == 0:
        return labels
    e = win_embs / (np.linalg.norm(win_embs, axis=1, keepdims=True) + 1e-9)
    wstart = np.asarray(win_starts_s, np.float64)
    starts = np.asarray(segs.starts)
    ends = np.asarray(segs.ends)
    # window -> segment membership: FULLY-INSIDE windows only.  Windows that
    # stick out of their segment mix in silence/neighbor context and form a
    # spurious low-similarity mode — with center-containment membership the
    # 60 s harness over-split to 4-8 speakers (edge windows dominate short
    # turns); fully-inside windows match the statistics the thresholds were
    # calibrated on.
    seg_of_win = np.full(len(wstart), -1, np.int64)
    order = np.argsort(starts)
    pos = np.searchsorted(starts[order], wstart, side="right") - 1
    valid = pos >= 0
    cand = order[np.clip(pos, 0, None)]
    inside = valid & (wstart + win_s <= ends[cand] + 1e-9)
    seg_of_win[inside] = cand[inside]

    # NOTE on membership (measured 2026-08-18): extending membership to
    # windows inside merged same-cluster SPANS (>=80% speech overlap, to
    # recover the cross-SCD-cut windows that same-speaker merging would own)
    # was tried and measured strictly WORSE — the added boundary windows
    # blur a true merged pair's modes (seed 2010: sub-cos 0.682 -> 0.794,
    # further from splitting) and reintroduce the drifting-single over-split
    # (seed 2005 @ scd z=1.0: 0.52% -> 16.5% DER).  Per-segment fully-inside
    # stays.
    es = None
    if seg_embs is not None:
        es = seg_embs / (np.linalg.norm(seg_embs, axis=1, keepdims=True) + 1e-9)
    changed = True
    did_split = False
    touched: set[int] = set()   # clusters created/modified by a split
    while changed and labels.max() + 1 < max_speakers:
        changed = False
        for c in range(int(labels.max()) + 1):
            member = np.where(labels == c)[0]
            if len(member) < 2:
                continue
            wmask = np.isin(seg_of_win, member)
            if wmask.sum() < min_windows:
                continue
            widx = np.where(wmask)[0]
            sub_cos, side = bisect_windows(e[widx])
            if sub_cos >= sub_cos_thr:
                continue
            if es is not None and side.any() and (~side).any():
                # side by the segment's own pooled embedding vs sub-centroids
                c0 = e[widx][side].mean(0)
                c1 = e[widx][~side].mean(0)
                c0 /= np.linalg.norm(c0) + 1e-9
                c1 /= np.linalg.norm(c1) + 1e-9
                seg_side = (es[member] @ c1) > (es[member] @ c0)
                # temporal-alternation veto: a real speaker pair inside one
                # cluster ALTERNATES turns (measured 0.32-0.50 side-switch
                # rate over time-sorted segments), while a slowly-drifting
                # single speaker bisects along time (0.18-0.29) — the one
                # statistic that separates the seed-41 false split
                # (sub-cos 0.491, a single!) from true pairs at comparable
                # sub-cos.  See STATUS.md 2026-08-19.
                order_t = np.argsort(starts[member])
                s_sorted = seg_side[order_t]
                if len(s_sorted) > 1:
                    alt = float(np.mean(s_sorted[1:] != s_sorted[:-1]))
                    if alt < 0.30:
                        continue
                # side-purity veto: for a real pair every segment's windows
                # agree on a side (measured mean purity 0.997-1.000), while
                # false splits of drifting/noisy singles flip sides within
                # segments (0.948-0.989 — e.g. the indomain seed-1002 single
                # at sub-cos 0.644, purity 0.987).
                purs = []
                for s in member:
                    sw = side[seg_of_win[widx] == s]
                    if sw.size:
                        purs.append(max(sw.mean(), 1.0 - sw.mean()))
                if purs and float(np.mean(purs)) < 0.995:
                    continue
                to_b = member[seg_side]
            else:
                # window-majority fallback (no segment embeddings given)
                to_b = [s for s in member
                        if (sw := side[seg_of_win[widx] == s]).size
                        and sw.mean() < 0.5]
                to_b = np.asarray(to_b, dtype=np.int64)
            if len(to_b) == 0 or len(to_b) == len(member):
                continue
            labels[to_b] = labels.max() + 1
            touched.update((c, int(labels.max())))
            changed = did_split = True
            if labels.max() + 1 >= max_speakers:
                break
    if did_split and es is not None and polish_iters > 0:
        # duration-weighted cosine k-means polish, RESTRICTED to segments of
        # clusters a split touched: the spectral assignment of untouched
        # clusters is authoritative (plain nearest-centroid would override
        # it and could even empty an untouched cluster, silently collapsing
        # the count below the spectral k / min_speakers bound)
        dur = (ends - starts).astype(np.float64)
        movable = np.isin(labels, np.asarray(sorted(touched), labels.dtype))
        for _ in range(polish_iters):
            k = int(labels.max()) + 1
            cents = np.zeros((k, es.shape[1]))
            for j in range(k):
                sel = labels == j
                if sel.any():
                    cents[j] = (es[sel] * dur[sel, None]).sum(0)
            cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-9
            new = (es @ cents.T).argmax(1).astype(labels.dtype)
            new = np.where(movable, new, labels)
            if (new == labels).all():
                break
            labels = new
        # polish can empty a touched cluster — relabel to contiguous 0..k-1
        uniq, inv = np.unique(labels, return_inverse=True)
        labels = inv.astype(labels.dtype)
    return labels


def spectral_cluster(
    embs,
    min_speakers: int = 1,
    max_speakers: int = 8,
    p_percentile: float | None = None,  # deprecated: affinity is auto-tuned
    pad_to: int = 64,
) -> np.ndarray:
    """Pads N up to a multiple of ``pad_to`` by cyclically repeating real
    rows (zero weight: duplicated points join existing clusters and keep the
    eigen-structure stable), as the JAX package does so that its compiled
    path recompiles per size bucket only.  Returns int labels [N], 0..k-1
    by first appearance."""
    embs = np.asarray(embs, dtype=np.float32)
    n = embs.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    if n == 1:
        return np.zeros((1,), dtype=np.int32)
    if n <= max_speakers:
        max_speakers = max(min(n - 1, max_speakers), 1)

    n_pad = max(pad_to, int(np.ceil(n / pad_to)) * pad_to)
    idx = np.arange(n_pad) % n
    padded = embs[idx]
    weights = (np.arange(n_pad) < n).astype(np.float32)
    labels = _spectral_labels_np(padded, weights, int(min_speakers),
                                 int(max_speakers))[:n]
    uniq, first_pos = np.unique(labels, return_index=True)
    order = uniq[np.argsort(first_pos)]
    remap = {int(u): i for i, u in enumerate(order)}
    return np.array([remap[int(l)] for l in labels], dtype=np.int32)

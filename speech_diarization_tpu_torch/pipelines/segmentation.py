"""Segmentation-driven diarization: the pyannote-3.1-scaffold analog (the
JAX package's ``pipelines/segmentation.py``).

A chunk-local speaker-activity net (``models/segmentation.py``) scores 5 s
chunks every ``chunk_hop_s`` for K local speaker slots; each active (chunk,
slot) span becomes a local segment, embedded off a 1 s / 0.1 s window grid
(purity-masked by the slot's exclusive activity) and clustered globally
(spectral or AHC), then stitched across chunk boundaries.  Unlike the
flagship VAD+SCD pipeline it represents overlapping speech.

The device part: the padded waveform goes to the device once; every chunk
is a row of an ``unfold`` view of it (rows ``chunk_hop_s`` apart, read in
place), so the whole file is ONE log-mel launch (K2's ``[B, T]`` entry) and
one forward of the net, as the JAX package scores it in one dispatch; then
the window grid through ``encode_fn`` (:func:`~..segment.embed.
embed_windows`, 512 windows a batch).  Everything after is host numpy,
copied from the JAX package in its dtypes: binarize, center-trim, purity
masks, clustering, merge.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from .. import cluster as cluster_mod
from ..segment.embed import embed_windows, segment_embeddings_from_grid, window_starts
from ..segment.merge import merge_adjacent
from ..types import SegmentArray
from ..utils.logging import get_logger, stage_timer

log = get_logger("segmentation")


@dataclass
class SegmentationConfig:
    chunk_s: float = 5.0
    # chunk stride; < chunk_s scores OVERLAPPING chunks and keeps only each
    # chunk's center frames (pyannote's aggregation-with-warm-up-trim idea:
    # the BiGRU has least context at chunk edges, so edge frames are the
    # least reliable).  None = non-overlapping chunks (old behavior).
    # MEASURED 2026-08-21 (exp_engine_cluster.py, conv ckpt + spectral,
    # pinned seg-eval-v1 files / alternate 7100+ draw): denser tiling wins
    # monotonically — hop 2.5 s reads 9.41/13.56% DER, 1.25 s 4.87/8.15,
    # 0.625 s **4.29/4.62** (conf collapses to 0.66/1.05: every frame is
    # judged by a chunk where it sits at the very center, and the slot
    # segments fragment less so the global clustering sees cleaner
    # pools).  8 chunks per 5 s is engine-path compute (one batched
    # dispatch), not the flagship bench path.
    chunk_hop_s: float | None = 0.625
    # pyannote-style aggregation: align each chunk's slot permutation to the
    # running global aggregate on their overlap, Hann-weight-average aligned
    # activities onto one global [T, K] timeline, binarize ONCE globally —
    # turns stay continuous across chunk boundaries instead of being cut at
    # every chunk edge and re-joined only if clustering agrees.
    # MEASURED OFF (2026-08-18, powerset ckpt best-perm 0.86): averaging
    # this checkpoint's soft activities dilutes them below onset — DER on
    # 3x40 s 2-spk files 33.0/44.2/58.2% vs 13.8/15.7/6.1% for center-trim.
    # Aggregation needs crisp (near-0/1) activities to win; re-measure when
    # a stronger segmentation checkpoint ships.
    aggregate: bool = False
    hop_ms: float = 10.0
    # activity binarization threshold.  0.3 (was 0.5) measured on 3x60 s
    # overlap-0.3 held-out files with the powerset checkpoint: miss
    # 31.3 -> 24.9 with FA flat at 3.7 (marginalized activities sit below
    # 0.5 exactly on overlapped frames, where the class posterior spreads
    # over multi-speaker subsets)
    onset: float = 0.3
    min_on_s: float = 0.25    # min active span (pyannote min_duration_on)
    min_off_s: float = 0.10   # fill gaps shorter than this (min_duration_off)
    grid_win_s: float = 1.0
    grid_hop_s: float = 0.1
    cos_threshold: float = 0.70
    min_speakers: int = 1
    max_speakers: int = 8
    merge_gap_s: float = 0.5
    # Purity-masked slot embeddings: weight each grid window by the slot's
    # EXCLUSIVE activity (act_k * prod_j!=k (1 - act_j)) over the window's
    # frames, so a slot segment that spans an overlapped region pools its
    # embedding from the frames where its speaker talks ALONE.  This is the
    # pyannote-3.1 idea of masked (chunk, speaker) embeddings — without it,
    # overlapped slot segments embed a 2-speaker mixture and the global
    # clustering confuses them (measured: conf 19.2% -> see STATUS).
    masked_embeddings: bool = True
    # global clustering backend over slot-segment embeddings: "spectral"
    # (the flagship's sharpened-affinity eigengap backend) or "ahc"
    # (threshold agglomerative, the pyannote default).  MEASURED 2026-08-21
    # (scripts/exp_engine_cluster.py, conv8k detections, pinned pipeline
    # files): spectral DER 9.41% (conf 1.97) vs ahc-0.70's 18.31% (conf
    # 11.09) — the eigengap count estimate + sharpened affinity fix the
    # slot-segment confusion AHC's fixed threshold leaves behind, taking
    # the engine BELOW the flagship (10.77%) on overlapping files.
    cluster_method: str = "spectral"


def _binarize_activity(act: np.ndarray, cfg: SegmentationConfig,
                       onset: float | None = None) -> list[tuple[int, int]]:
    """[F] activity -> list of (f0, f1) active frame spans with min-on/off.

    ``onset`` overrides ``cfg.onset`` — hard argmax-decoded activities
    binarize at 0.5 (majority vote after aggregation averaging; exact on
    raw {0,1} per-chunk decisions), while the 0.3 default was tuned for
    soft powerset marginals (which sit below 0.5 on overlapped frames)."""
    on = act >= (cfg.onset if onset is None else onset)
    if not on.any():
        return []
    hop_s = cfg.hop_ms / 1000.0
    min_on = max(1, int(round(cfg.min_on_s / hop_s)))
    min_off = max(1, int(round(cfg.min_off_s / hop_s)))
    idx = np.flatnonzero(np.diff(np.concatenate([[0], on.astype(np.int8), [0]])))
    spans = list(zip(idx[::2], idx[1::2]))
    # fill short gaps, then drop short spans
    merged: list[tuple[int, int]] = []
    for f0, f1 in spans:
        if merged and f0 - merged[-1][1] < min_off:
            merged[-1] = (merged[-1][0], f1)
        else:
            merged.append((f0, f1))
    return [(f0, f1) for f0, f1 in merged if f1 - f0 >= min_on]


def aggregate_chunk_activities(
    acts: np.ndarray,
    stride_f: int,
    paired: np.ndarray | None = None,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Stitch per-chunk slot activities into one global timeline
    (pyannote's inference aggregation, ``pyannote.audio`` Inference
    sliding-window semantics — the analog the reference consumes as a
    binary via ``diarization_baseline.py:170-181``).

    ``acts``: [n_chunks, F, K] slot activities from chunks taken every
    ``stride_f`` frames.  Slot identity is chunk-local (PIT training), so
    each chunk is first aligned to the running aggregate by the best slot
    permutation on the overlap region (K! enumeration, K <= 4), then its
    activities are Hann-weight-averaged into the global [T, K] timeline.
    """
    import itertools

    n_chunks, f, k = acts.shape
    t_total = (n_chunks - 1) * stride_f + f
    agg = np.zeros((t_total, k), np.float64)
    agg2 = np.zeros((t_total, k), np.float64) if paired is not None else None
    wsum = np.zeros((t_total, 1), np.float64)
    # Hann-like weights favor chunk centers where the BiGRU has context on
    # both sides; +eps keeps edge frames covered at the file boundaries
    w = (np.hanning(f + 2)[1:-1] + 1e-3)[:, None]
    perms = list(itertools.permutations(range(k)))
    for c in range(n_chunks):
        lo = c * stride_f
        a = acts[c].astype(np.float64)
        p_best = list(range(k))
        if c > 0:
            # overlap with the aggregate so far: frames [lo, prev_end)
            ov = min((c - 1) * stride_f + f, t_total) - lo
            if ov > 0:
                ref = agg[lo : lo + ov] / np.maximum(wsum[lo : lo + ov], 1e-9)
                errs = [float(((a[:ov, list(p)] - ref) ** 2).sum())
                        for p in perms]
                p_best = list(perms[int(np.argmin(errs))])
                a = a[:, p_best]
        agg[lo : lo + f] += w * a
        if agg2 is not None:
            # the paired array (hard argmax decisions) rides the SAME slot
            # permutation the soft marginals aligned with
            agg2[lo : lo + f] += w * paired[c].astype(np.float64)[:, p_best]
        wsum[lo : lo + f] += w
    out = (agg / np.maximum(wsum, 1e-9)).astype(np.float32)
    if agg2 is None:
        return out
    return out, (agg2 / np.maximum(wsum, 1e-9)).astype(np.float32)


def _exclusive_activity(act: np.ndarray) -> np.ndarray:
    """[F, K] slot activities -> [F, K] exclusive activities
    (slot k active AND every other slot silent).

    Activities are clipped away from exactly 1.0 first: a saturated slot
    (float32 sigmoid/powerset emit exact 1.0 on confident frames) would
    otherwise contribute an exact-0 factor to ``prod_all`` while its own
    denominator is clamped to 1e-6, zeroing the exclusive activity on
    precisely the frames where the speaker most confidently talks alone."""
    act = np.clip(act, 0.0, 1.0 - 1e-6)
    one_minus = 1.0 - act
    prod_all = one_minus.prod(axis=-1, keepdims=True)
    # prod over j != k (leave-one-out via division; clip above keeps it exact)
    return act * prod_all / one_minus


def _masked_segment_embeddings(
    win_embs: np.ndarray,       # [W, D]
    win_starts_s: np.ndarray,   # [W]
    win_s: float,
    segs: SegmentArray,
    purities: list[np.ndarray],  # per-segment [n_frames_i] exclusive act
    seg_f0: np.ndarray,          # [S] global start frame of each purity row
    hop_s: float,
    min_overlap_s: float = 0.25,
) -> np.ndarray:
    """Slot-segment embeddings pooled from grid windows weighted by
    overlap-seconds x mean EXCLUSIVE slot activity over the window.

    Windows that land where the slot's speaker talks alone dominate the
    pool; overlapped stretches (where the window embedding is a 2-speaker
    mixture) are suppressed.  Falls back to plain overlap weighting when a
    segment has no usably-pure window (fully-overlapped segments)."""
    n = len(segs)
    if n == 0 or win_embs.shape[0] == 0:
        return np.zeros((n, win_embs.shape[1] if win_embs.size else 1), np.float32)
    ws = np.asarray(win_starts_s, np.float64)
    starts = np.asarray(segs.starts, np.float64)
    ends = np.asarray(segs.ends, np.float64)
    a_idx = np.searchsorted(ws, starts - win_s, side="right")
    b_idx = np.searchsorted(ws, ends, side="left")
    out = np.zeros((n, win_embs.shape[1]), np.float32)
    for i in range(n):
        a, b = int(a_idx[i]), int(b_idx[i])
        if b <= a:
            out[i] = win_embs[min(max(a, 0), len(ws) - 1)]
            continue
        local = ws[a:b]
        ov = np.minimum(ends[i], local + win_s) - np.maximum(starts[i], local)
        w_ov = np.where(ov >= min_overlap_s, ov, 0.0)
        pur = purities[i]
        f0 = int(seg_f0[i])
        # mean exclusive activity over each window's frames inside the segment
        lo_f = np.maximum((np.maximum(local, starts[i]) / hop_s).astype(np.int64) - f0, 0)
        hi_f = np.minimum((np.minimum(local + win_s, ends[i]) / hop_s).astype(np.int64) - f0,
                          len(pur))
        cs = np.concatenate([[0.0], np.cumsum(pur, dtype=np.float64)])
        cnt = np.maximum(hi_f - lo_f, 1)
        mean_pur = (cs[np.maximum(hi_f, lo_f)] - cs[lo_f]) / cnt
        w = w_ov * mean_pur
        if w.sum() < 1e-6:      # fully-overlapped segment: plain overlap pool
            w = w_ov
        tot = w.sum()
        if tot < 1e-9:          # all slivers: single best-overlapping window
            out[i] = win_embs[a + int(np.argmax(ov))]
            continue
        out[i] = (w / tot) @ win_embs[a:b]
    return out


def segmentation_diarize(
    y,
    sr: int,
    seg_activities_fn: Callable,
    encode_fn: Callable,
    cfg: SegmentationConfig | None = None,
) -> SegmentArray:
    """wav -> globally-labeled (possibly overlapping) segments.

    Args:
        y: the waveform, a host array (as read, no preprocessing).
        seg_activities_fn: ``[n_chunks, T_chunk] -> [n_chunks, F, K]`` (or
            ``2K``: soft ‖ hard when ``fn.dual``) on ``fn.device``, from
            :func:`make_seg_activities_fn`.
        encode_fn: ``[B, T] -> [B, D]`` speaker embedder.
    """
    cfg = cfg or SegmentationConfig()
    y = np.asarray(y, np.float32)
    chunk = int(cfg.chunk_s * sr)
    stride_s = cfg.chunk_hop_s if cfg.chunk_hop_s else cfg.chunk_s
    stride = max(1, int(stride_s * sr))
    n_chunks = max(1, -(-max(len(y) - chunk, 0) // stride) + 1)
    dev = getattr(seg_activities_fn, "device", torch.device("cpu"))
    with stage_timer(log, "seg-score"):
        y_dev = torch.from_numpy(y).to(dev)
        # the chunks are rows of a view of the padded wave, ``stride`` apart
        yp = F.pad(y_dev, (0, max(0, (n_chunks - 1) * stride + chunk - len(y))))
        chunks = yp.unfold(0, chunk, stride)             # [n_chunks, chunk]
        acts = seg_activities_fn(chunks).float().cpu().numpy()  # [n_chunks, F, K or 2K]
    hard = None
    if getattr(seg_activities_fn, "dual", False):
        k2 = acts.shape[-1] // 2
        acts, hard = acts[..., :k2], acts[..., k2:]
    hop_s = cfg.hop_ms / 1000.0
    with stage_timer(log, "seg-local"):
        starts, ends = [], []
        purs: list[np.ndarray] = []   # per-segment exclusive-activity timelines
        f0s: list[int] = []           # global start frame of each purity row
        max_t = len(y) / sr
        if cfg.aggregate and n_chunks > 1:
            stride_f = int(round(stride / (hop_s * sr)))
            if hard is not None:
                glob, ghard = aggregate_chunk_activities(acts, stride_f, hard)
            else:
                glob, ghard = aggregate_chunk_activities(acts, stride_f), None
            ex = _exclusive_activity(glob)
            bin_src = ghard if ghard is not None else glob
            bin_on = 0.5 if ghard is not None else None
            for k in range(glob.shape[1]):
                for f0, f1 in _binarize_activity(bin_src[:, k], cfg, onset=bin_on):
                    s, e = f0 * hop_s, min(f1 * hop_s, max_t)
                    if e - s >= cfg.min_on_s and s < max_t:
                        starts.append(s)
                        ends.append(e)
                        purs.append(ex[f0:f1, k])
                        f0s.append(f0)
        else:
            # per-chunk kept frame range: the center stride_s of each chunk
            # (first chunk keeps its head, last keeps its tail) so overlapping
            # chunks tile the timeline with their most-context-rich frames
            trim_f = int(round((cfg.chunk_s - stride_s) / 2.0 / hop_s))
            n_frames = acts.shape[1]
            chunk_f0 = [int(round(c * stride / (hop_s * sr))) for c in range(n_chunks)]
            for c in range(n_chunks):
                lo = 0 if c == 0 else trim_f
                hi = n_frames if c == n_chunks - 1 else n_frames - trim_f
                ex = _exclusive_activity(acts[c])
                for k in range(acts.shape[2]):
                    spans = (_binarize_activity(hard[c, :, k], cfg, onset=0.5)
                             if hard is not None
                             else _binarize_activity(acts[c, :, k], cfg))
                    for f0, f1 in spans:
                        f0c, f1c = max(f0, lo), min(f1, hi)
                        if f1c <= f0c:
                            continue
                        s = (c * stride + f0c * hop_s * sr) / sr
                        e = min((c * stride + f1c * hop_s * sr) / sr, max_t)
                        if e - s >= cfg.min_on_s:
                            starts.append(s)
                            ends.append(e)
                            purs.append(ex[f0c:f1c, k])
                            f0s.append(chunk_f0[c] + f0c)
    if not starts:
        return SegmentArray.from_pairs([])
    local = SegmentArray(np.asarray(starts), np.asarray(ends))
    log.info("segmentation: %d local (chunk, slot) segments", len(local))

    # embeddings from the shared dense grid (one batched encode pass)
    with stage_timer(log, "seg-embed-grid"), torch.inference_mode():
        win_embs = embed_windows(encode_fn, y_dev, sr, cfg.grid_win_s,
                                 cfg.grid_hop_s).float().cpu().numpy()
    grid_starts = window_starts(len(y), sr, cfg.grid_win_s, cfg.grid_hop_s) / sr
    with stage_timer(log, "seg-embeddings"):
        if cfg.masked_embeddings:
            embs = _masked_segment_embeddings(
                win_embs, grid_starts, cfg.grid_win_s, local,
                purs, np.asarray(f0s, np.int64), hop_s)
        else:
            embs = segment_embeddings_from_grid(
                win_embs, grid_starts, cfg.grid_win_s, local)

    with stage_timer(log, "seg-cluster"):
        if cfg.cluster_method == "spectral":
            labels = cluster_mod.spectral_cluster(
                embs, min_speakers=cfg.min_speakers, max_speakers=cfg.max_speakers)
        else:
            labels = cluster_mod.ahc_cluster(
                embs, cos_threshold=cfg.cos_threshold,
                min_speakers=cfg.min_speakers, max_speakers=cfg.max_speakers,
            )
    segs = SegmentArray(local.starts, local.ends, labels.astype(np.int32)).sort()
    # stitch across chunk boundaries + inside chunks
    return merge_adjacent(segs, cfg.merge_gap_s)


def make_seg_activities_fn(model) -> Callable:
    """The batched chunk scorer of a :class:`~..models.segmentation.
    SegmentationModel`, on the model's device (``fn.device``).

    Powerset nets emit ``[n_chunks, F, 2K]`` = soft marginals ‖ HARD
    argmax-decoded activities (``fn.dual = True``): the pipeline binarizes on
    the hard decisions and keeps the soft marginals for exclusive-activity
    masking and aggregation alignment.  Sigmoid nets return plain soft
    activities (``fn.dual = False``)."""
    net = model.net

    if net.powerset:
        def fn(chunks: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                lg = model.head_logits(chunks)
                soft = torch.softmax(lg, dim=-1) @ net.memb
                return torch.cat([soft, net.memb[torch.argmax(lg, dim=-1)]], dim=-1)

        fn.dual = True
    else:
        def fn(chunks: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return model.activities(chunks)

        fn.dual = False
    fn.device = net.memb.device
    return fn

"""Overlap rescue: add second-speaker segments on top of the flagship
diarization.

The flagship VAD+SCD chain emits at most one speaker per instant.  The
segmentation model detects overlapped frames well, but its own local-to-
global stitching loses to the flagship's speaker map.  This module combines
the two: the flagship provides the global speaker map, the segmentation
model only answers *where do two people talk at once*, and each overlap
region gains one extra segment for the most plausible second speaker:

* region spans a flagship speaker CHANGE -> the two adjacent speakers are
  the overlap pair (turn-taking overlap, the dominant conversational
  case): each side's segment extends across the region;
* region inside a single speaker's turn -> the second speaker is the
  best-cosine match of the region's grid embedding among the OTHER
  speakers' centroids (backchannel overlap), subject to a cosine floor.

All decisions are host-side numpy over tensors the pipeline already
computed (dense grid window embeddings + final labels).  The detector's
device work is either part of the streamed per-chunk program
(``pipelines/diarize.py``) or, standalone, :func:`detect_overlap_regions`:
one upload of the waveform and batches of 24 windows cut from it on the
device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import SegmentArray
from ..utils.device import resolve_device
from ..utils.logging import count, get_logger, stage_timer

log = get_logger("overlap")

GATHER_BATCH = 24   # windows per detector call: one fixed shape


def make_seg_hard_fn(model):
    """``[n, T] tensor -> [n, F, K]`` hard slot decisions of a
    :class:`~..models.segmentation.SegmentationModel` (argmax over the
    powerset classes, or a 0.5 threshold on a sigmoid head), under
    ``inference_mode``; the tensor lies on the model's device."""
    model = model.eval()

    def fn(chunks: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.hard_activities(chunks)

    return fn


def detect_overlap_regions(
    y: np.ndarray | torch.Tensor,
    sr: int,
    seg_fn,
    chunk_s: float = 5.0,
    chunk_hop_s: float = 2.5,
    hop_ms: float = 10.0,
    min_on_s: float = 0.3,
    min_gap_s: float = 0.15,
    device: str | torch.device | None = None,
) -> SegmentArray:
    """Frames where the segmentation model decodes >= 2 active speakers.

    ``seg_fn`` maps a ``[n, chunk]`` tensor on ``device`` to ``[n, F, K]``
    hard decisions (:func:`make_seg_hard_fn`; any callable returning a
    tensor or an array does).  Chunks tile the file with centre-trim.  The
    waveform is uploaded once (not at all when it is a tensor on
    ``device`` already), zero-padded to whole batches; each batch of
    ``GATHER_BATCH`` windows is an ``unfold`` view of it.  ``device``:
    ``None`` is the card (raises without CUDA)."""
    y = torch.as_tensor(y, dtype=torch.float32, device=resolve_device(device))
    t = y.shape[-1]
    chunk = int(chunk_s * sr)
    stride = max(1, int(chunk_hop_s * sr))
    n_chunks = max(1, -(-max(t - chunk, 0) // stride) + 1)
    n_batches = -(-n_chunks // GATHER_BATCH)
    pad_to = (n_batches * GATHER_BATCH - 1) * stride + chunk
    yp = torch.nn.functional.pad(y, (0, max(0, pad_to - t)))
    span = (GATHER_BATCH - 1) * stride + chunk
    parts = []
    for b in range(n_batches):
        start = b * GATHER_BATCH * stride
        wins = yp[start:start + span].unfold(0, chunk, stride)
        out = seg_fn(wins)
        if isinstance(out, torch.Tensor):
            with stage_timer(log, "overlap.copy", wait=True):
                out = out.cpu().numpy()
                count("d2h_bytes", out.nbytes)
        parts.append(np.asarray(out))
    acts = np.concatenate(parts, axis=0)[:n_chunks]
    return regions_from_hard_acts(acts, t / sr, chunk_hop_s=chunk_hop_s,
                                  hop_ms=hop_ms, min_on_s=min_on_s,
                                  min_gap_s=min_gap_s)


def regions_from_hard_acts(
    acts: np.ndarray,
    total_s: float,
    chunk_hop_s: float = 2.5,
    hop_ms: float = 10.0,
    min_on_s: float = 0.3,
    min_gap_s: float = 0.15,
) -> SegmentArray:
    """[n_chunks, F, K] HARD slot decisions (chunks every ``chunk_hop_s``)
    -> overlap regions.  Host post-processing half of
    :func:`detect_overlap_regions`, shared with the streamed ingest where
    the activities come out of the per-chunk device program and ride its
    packed copy.  The first chunk keeps its head and the last its tail;
    every other frame is judged by the chunk whose centre covers it.  The
    frame arithmetic is in Python floats, as in the JAX package: another
    rounding moves a frame count by one."""
    hop_f = hop_ms / 1000.0
    n_chunks, f_per_chunk = acts.shape[0], acts.shape[1]
    stride_f = int(round(chunk_hop_s / hop_f))
    total_f = int(total_s / hop_f) + 1
    n_active = np.zeros(total_f, np.float32)
    trim = max(0, (f_per_chunk - stride_f) // 2)
    for c in range(n_chunks):
        lo = 0 if c == 0 else trim
        hi = f_per_chunk if c == n_chunks - 1 else f_per_chunk - trim
        g0 = c * stride_f + lo
        g1 = min(c * stride_f + hi, total_f)
        if g1 > g0:
            n_active[g0:g1] = acts[c, lo:lo + (g1 - g0)].sum(-1)

    on = n_active >= 2.0
    if not on.any():
        return SegmentArray.from_pairs([])
    edges = np.flatnonzero(np.diff(np.concatenate([[0], on.astype(np.int8), [0]])))
    spans = list(zip(edges[::2], edges[1::2]))
    # fill sub-min_gap holes, then drop sub-min_on spans
    merged: list[tuple[int, int]] = []
    gap_f = max(1, int(round(min_gap_s / hop_f)))
    for f0, f1 in spans:
        if merged and f0 - merged[-1][1] < gap_f:
            merged[-1] = (merged[-1][0], f1)
        else:
            merged.append((f0, f1))
    min_f = max(1, int(round(min_on_s / hop_f)))
    keep = [(f0 * hop_f, f1 * hop_f) for f0, f1 in merged if f1 - f0 >= min_f]
    return SegmentArray.from_pairs(keep)


def add_overlap_segments(
    final: SegmentArray,
    regions: SegmentArray,
    win_embs: np.ndarray,
    starts_s: np.ndarray,
    win_s: float,
    min_cos: float = 0.10,
    max_overlap_frac: float = 0.5,
) -> SegmentArray:
    """Insert one second-speaker segment per overlap region (see module doc).

    ``max_overlap_frac``: safety veto — if the segmentation model marks
    more than this fraction of the total speech as overlapped, it is
    hallucinating on out-of-family audio and the rescue is skipped."""
    if len(regions) == 0 or len(final) == 0:
        return final
    n_spk = int(final.spks.max()) + 1 if len(final) else 0
    if n_spk < 2:
        return final
    total_speech = float(np.sum(final.ends - final.starts))
    total_ov = float(np.sum(regions.ends - regions.starts))
    if total_speech <= 0 or total_ov > max_overlap_frac * total_speech:
        log.info("overlap rescue: %.1fs overlap vs %.1fs speech — over the "
                 "%.0f%% sanity cap, skipping", total_ov, total_speech,
                 100 * max_overlap_frac)
        return final

    # speaker centroids from the grid windows covered by each speaker's
    # final segments (duration-weighted by window-segment intersection)
    e = win_embs / (np.linalg.norm(win_embs, axis=1, keepdims=True) + 1e-9)
    w_end = starts_s + win_s
    cents = np.zeros((n_spk, e.shape[1]), np.float64)
    for k in range(n_spk):
        m = final.spks == k
        if not m.any():
            continue
        inter = (np.minimum(w_end[:, None], final.ends[None, m])
                 - np.maximum(starts_s[:, None], final.starts[None, m]))
        wgt = np.clip(inter, 0.0, None).sum(1)
        if wgt.sum() > 0:
            cents[k] = (e * wgt[:, None]).sum(0) / wgt.sum()
    cents /= np.linalg.norm(cents, axis=1, keepdims=True) + 1e-9

    add_s, add_e, add_k = [], [], []
    for r0, r1 in zip(regions.starts, regions.ends):
        # flagship speakers with real presence (>=25% of the region)
        inter = (np.minimum(final.ends, r1) - np.maximum(final.starts, r0))
        cov = np.clip(inter, 0.0, None)
        present = {}
        for s, d in zip(final.spks, cov):
            if d > 0:
                present[int(s)] = present.get(int(s), 0.0) + float(d)
        main = [k for k, d in sorted(present.items(), key=lambda t: -t[1])
                if d >= 0.25 * (r1 - r0)]
        if not main:
            continue  # flagship says non-speech here: seg-model FA
        if len(main) >= 2:
            # turn-change overlap: both adjacent speakers span the region
            for k in main[:2]:
                add_s.append(r0), add_e.append(r1), add_k.append(k)
            continue
        # backchannel overlap: second speaker by grid-embedding match
        wgt = np.clip(np.minimum(w_end, r1) - np.maximum(starts_s, r0),
                      0.0, None)
        if wgt.sum() <= 0:
            continue
        remb = (e * wgt[:, None]).sum(0) / wgt.sum()
        remb /= np.linalg.norm(remb) + 1e-9
        cos = cents @ remb
        cos[main[0]] = -2.0
        k2 = int(np.argmax(cos))
        if cos[k2] >= min_cos:
            add_s.append(r0), add_e.append(r1), add_k.append(k2)

    if not add_s:
        return final
    log.info("overlap rescue: +%d second-speaker segments over %d regions",
             len(add_s), len(regions))
    out = SegmentArray(
        np.concatenate([final.starts, np.asarray(add_s)]),
        np.concatenate([final.ends, np.asarray(add_e)]),
        np.concatenate([final.spks, np.asarray(add_k, final.spks.dtype)]),
    )
    return out.sort()

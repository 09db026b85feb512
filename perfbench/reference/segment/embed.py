"""Grid geometry, the whole-file window grid, segment embeddings over it,
and the bucketed per-segment embeddings.

Every downstream consumer (SCD distances, segment embeddings, the refine
bisection) reads the same [W, D] window-embedding matrix, computed once per
file: by the per-chunk device program on the streamed path, by
:func:`embed_windows_streaming` on the whole-file path, or, for an encoder
that is not streaming-trained, by :func:`embed_windows` (one forward per
window: the windowed grid).  :func:`embed_segments_bucketed` instead embeds
each segment's own snippet (``EmbedConfig.mode='bucketed'``).  The rest of
this module is host numpy.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.framing import num_frames
from ..types import SegmentArray

# a per-utterance encoder: [B, T] waveforms -> [B, D] embeddings
EncodeFn = Callable[[torch.Tensor], torch.Tensor]

def window_starts(n_samples: int, sr: int, win_s: float, hop_s: float) -> np.ndarray:
    """Start sample index of each grid window (host ints)."""
    win = int(round(win_s * sr))
    hop = int(round(hop_s * sr))
    n = num_frames(n_samples, win, hop, pad_tail=True)
    return np.arange(n) * hop


def embed_windows(encode_fn: EncodeFn, y: torch.Tensor, sr: int, win_s: float,
                  hop_s: float, batch: int = 512) -> torch.Tensor:
    """The whole-file window grid of a per-utterance encoder: [T] -> [W, D]
    on ``y``'s device, every window (the tail zero-padded) through
    ``encode_fn`` ([B, T] -> [B, D], e.g. ``EcapaModel.encode_batch``) in
    batches of ``batch`` windows.  The windows
    are a view of the padded waveform (``Tensor.unfold``): the log-mel
    kernel reads each batch's rows in place by their stride.  Each window
    is encoded on its own (reflect pad, mean-norm and pooling per row), so
    a window's embedding does not depend on ``batch`` (the JAX package's
    auto-bucketing only bounds its compile shapes; the last batch here
    holds the real windows only)."""
    win = int(round(win_s * sr))
    hop = int(round(hop_s * sr))
    w = num_frames(y.shape[-1], win, hop, pad_tail=True)
    if w == 0:
        return y.new_zeros((0, 1))
    frames = F.pad(y, (0, max(0, (w - 1) * hop + win - y.shape[-1]))
                   ).unfold(0, win, hop)                       # [W, win], a view
    return torch.cat([encode_fn(frames[i:i + batch]) for i in range(0, w, batch)])


def embed_windows_streaming(model, y: torch.Tensor, sr: int, win_s: float,
                            hop_s: float, windows_per_chunk: int = 600,
                            margin_s: float = 4.0) -> torch.Tensor:
    """The whole-file window grid of a streaming encoder: [T] -> [W, D] on
    ``y``'s device.  The trunk runs once per chunk of ``wpc`` windows
    (``EcapaModel.encode_grid_chunk``: one log-mel and one pooling launch a
    chunk), each chunk carrying ``margin_s`` (rounded up to whole hops) of
    real context on both sides (the default 4 s is more than the trunk's
    reach, so core windows equal a whole-file pass); ``wpc`` is
    ``windows_per_chunk`` or, for a short file, the next power of two (at
    least 64) above its window count."""
    win = int(round(win_s * sr))
    hop = int(round(hop_s * sr))
    w = num_frames(y.shape[-1], win, hop, pad_tail=True)
    if w == 0:
        return y.new_zeros((0, 1))
    wpc = min(windows_per_chunk, 1 << max(6, (w - 1).bit_length()))
    margin = -(-int(round(margin_s * sr)) // hop) * hop
    span = 2 * margin + (wpc - 1) * hop + win
    n_chunks = -(-w // wpc)
    needed = margin + ((n_chunks - 1) * wpc + wpc - 1) * hop + win + margin
    y_pad = F.pad(y, (margin, max(0, needed - margin - y.shape[-1])))
    outs = [model.encode_grid_chunk(y_pad[c * wpc * hop:c * wpc * hop + span],
                                    wpc, margin, win, hop)
            for c in range(n_chunks)]
    return torch.cat(outs)[:w]


def segment_overlap_weights(segs: SegmentArray, win_starts_s: np.ndarray,
                            win_s: float) -> np.ndarray:
    """[S, W] overlap (seconds) of each grid window with each segment."""
    ws = win_starts_s[None, :]
    we = ws + win_s
    overlap = np.minimum(we, segs.ends[:, None]) - np.maximum(ws, segs.starts[:, None])
    return np.clip(overlap, 0.0, None)


def segment_embeddings_from_grid(
    win_embs: np.ndarray,  # [W, D]
    win_starts_s: np.ndarray,  # [W]
    win_s: float,
    segs: SegmentArray,
    min_overlap_s: float = 0.25,
) -> np.ndarray:
    """Segment embeddings as overlap-weighted means of grid-window embeddings
    (one [S,W]@[W,D] matmul).  Segments too short to fully cover a window fall
    back to the single best-overlapping window — the analog of the reference's
    context padding for short segments (``anti_stick_diarize.py:155-161``)."""
    n = len(segs)
    if n == 0 or win_embs.shape[0] == 0:
        return np.zeros((n, win_embs.shape[1] if win_embs.size else 1), np.float32)
    # Per-segment LOCAL window ranges instead of the dense [S, W] weight
    # matrix: a segment only overlaps windows starting in
    # (start - win_s, end), ~dozens at the 100 ms grid — the dense version
    # allocated 200+ MB and took 32 s of host time at hour scale.  Same
    # math exactly (overlap-seconds weights, sliver threshold, best-window
    # fallback), tested equal in tests/test_segment.py.
    ws = np.asarray(win_starts_s, np.float64)
    starts = np.asarray(segs.starts, np.float64)
    ends = np.asarray(segs.ends, np.float64)
    a_idx = np.searchsorted(ws, starts - win_s, side="right")
    b_idx = np.searchsorted(ws, ends, side="left")
    out = np.zeros((n, win_embs.shape[1]), np.float32)
    for i in range(n):
        a, b = int(a_idx[i]), int(b_idx[i])
        if b <= a:  # no window starts inside: nearest window wins
            j = min(max(a, 0), len(ws) - 1)
            out[i] = win_embs[j]
            continue
        local = ws[a:b]
        ov = np.minimum(ends[i], local + win_s) - np.maximum(starts[i], local)
        w = np.where(ov >= min_overlap_s, ov, 0.0)
        tot = w.sum()
        if tot < 1e-9:  # all slivers: single best-overlapping window
            out[i] = win_embs[a + int(np.argmax(ov))]
            continue
        out[i] = (w / tot) @ win_embs[a:b]
    return out


def _bucket_len(n: int, min_len: int) -> int:
    b = min_len
    while b < n:
        b *= 2
    return b


def embed_segments_bucketed(
    encode_fn,
    y,
    sr: int,
    segs: SegmentArray,
    min_duration_ms: float = 500.0,
    pad_duration_ms: float = 150.0,
    batch: int = 32,
    min_bucket_s: float = 0.5,
    max_bucket_s: float = 16.0,
) -> np.ndarray:
    """Reference-style per-segment embeddings (``anti_stick_diarize.py:130-172``)
    in power-of-two length buckets, as the JAX package computes them.

    Each snippet (context-padded by ``pad_duration_ms`` each side when
    shorter than ``min_duration_ms``, cut at ``max_bucket_s``) is zero-padded
    to its bucket, the next power of two times ``min_bucket_s`` at or above
    its length (at most ``max_bucket_s``): the zero tail enters the log-mel,
    the per-row mean-norm and the pooling, so the bucket is part of the
    embedding.  Groups of up to ``batch`` snippets of one bucket go through
    ``encode_fn`` ([B, T] -> [B, D]) together.  The JAX package pads a
    partial group with zero rows; the rows are encoded independently, so
    only the real rows go here (a contiguous [B, T] batch, one log-mel
    launch on the card).  ``y``: host array or tensor (copied to the host
    once)."""
    n = len(segs)
    if n == 0:
        return np.zeros((0, 1), dtype=np.float32)
    if isinstance(y, torch.Tensor):
        y = y.detach().cpu().numpy()
    y = np.asarray(y)
    min_dur = int(min_duration_ms / 1000.0 * sr)
    pad = int(pad_duration_ms / 1000.0 * sr)
    min_bucket = int(min_bucket_s * sr)
    max_bucket = int(max_bucket_s * sr)

    snippets: list[np.ndarray] = []
    for s, e in zip(segs.starts, segs.ends):
        i0, i1 = int(s * sr), int(e * sr)
        if i1 - i0 < min_dur:
            i0, i1 = max(0, i0 - pad), min(len(y), i1 + pad)
        snippets.append(y[i0:i1][:max_bucket])

    buckets: dict[int, list[int]] = {}
    for i, snip in enumerate(snippets):
        b = min(_bucket_len(max(len(snip), 1), min_bucket), max_bucket)
        buckets.setdefault(b, []).append(i)

    embs: np.ndarray | None = None
    for blen, idxs in sorted(buckets.items()):
        for j in range(0, len(idxs), batch):
            group = idxs[j:j + batch]
            mat = np.zeros((len(group), blen), dtype=np.float32)
            for row, i in enumerate(group):
                mat[row, :len(snippets[i])] = snippets[i]
            out = encode_fn(torch.from_numpy(mat)).float().cpu().numpy()
            if embs is None:
                embs = np.zeros((n, out.shape[1]), dtype=np.float32)
            embs[group] = out
    return embs

"""Framewise models over long audio in fixed-length overlapping chunks.

The JAX package's ``pipelines/chunking.py::chunked_framewise``: by default
15 s chunks at a 1 s overlap, evaluated as one ``[G, chunk]`` batch per
group of at most 64 chunks (``GROUP_BUCKETS``), stitched so that each chunk
gives up its last 25 frames (reflect-padded context) to the next one.  The
chunks are a view of the padded waveform (``Tensor.unfold`` at the chunk
hop), so a model that reads rows by their stride (the log-mel kernel's
``[B, T]`` entry) never copies them.  The JAX package pads each group to
its bucket with zero rows; the rows are independent, so only the real
chunks run here.  The stitch is one gather on the device.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.logging import count, get_logger, stage_timer

log = get_logger("chunking")

GROUP_BUCKETS = (4, 8, 16, 32, 64)


def stitch_index(n_chunks: int, frames_per_chunk: int, chunk_hop_frames: int,
                 n_frames_total: int, edge_margin_frames: int) -> np.ndarray:
    """For every output frame, its position in the flattened
    ``[n_chunks, frames_per_chunk]`` chunk outputs."""
    overlap = frames_per_chunk - chunk_hop_frames
    m = min(edge_margin_frames, max(overlap - 1, 0))
    src = np.full(n_frames_total, -1, np.int64)
    for k in range(n_chunks):
        lo = 0 if k == 0 else overlap - m
        hi = frames_per_chunk if k == n_chunks - 1 else frames_per_chunk - m
        a = k * chunk_hop_frames + lo
        b = min(a + (hi - lo), n_frames_total)
        src[a:b] = k * frames_per_chunk + np.arange(lo, lo + (b - a))
    if (src < 0).any():
        raise ValueError("chunk geometry leaves frames uncovered")
    return src


def chunked_framewise(fn: Callable[[torch.Tensor], torch.Tensor],
                      y: torch.Tensor, sr: int, frame_hop: int,
                      chunk_s: float = 15.0, overlap_s: float = 1.0,
                      frames_per_chunk_extra: int = 1, group: int | None = None,
                      edge_margin_frames: int = 25) -> torch.Tensor:
    """``fn``: [G, chunk] -> [G, chunk // frame_hop + frames_per_chunk_extra]
    (rows independent; 1 extra is the centred-frame count).  Returns the
    stitched [len(y) // frame_hop + frames_per_chunk_extra] frames on
    ``y``'s device.  Chunks are ``chunk_s`` long every ``chunk_s -
    overlap_s``; each gives up ``edge_margin_frames`` of its last frames to
    the next one.  ``fn`` takes ``group`` chunks a call (None: the smallest
    ``GROUP_BUCKETS`` entry that covers the file, at most 64); it changes no
    result.

    A ``fn`` with a few frames fewer a row (the energy VAD's uncentred
    frames) is taken as the JAX package takes it: a file of one chunk keeps
    the frames there are, and past one chunk a row's last frame stands in
    for the missing ones (the JAX stitch reads them only when the last chunk
    is within those frames of full, and raises there)."""
    t = int(y.shape[-1])
    chunk = int(round(chunk_s * sr))
    hop_samples = chunk - int(round(overlap_s * sr))
    if hop_samples % frame_hop:
        raise ValueError("the chunk hop must align to the frame hop")
    n_total = t // frame_hop + frames_per_chunk_extra
    fpc = chunk // frame_hop + frames_per_chunk_extra
    if t <= chunk:
        return fn(F.pad(y, (0, chunk - t))[None])[0, :n_total]
    n_chunks = -(-(t - chunk) // hop_samples) + 1
    rows = F.pad(y, (0, (n_chunks - 1) * hop_samples + chunk - t)
                 ).unfold(0, chunk, hop_samples)                 # a view
    if group is None:
        group = next((b for b in GROUP_BUCKETS if b >= n_chunks), GROUP_BUCKETS[-1])
    outs = torch.cat([fn(rows[g:g + group]) for g in range(0, n_chunks, group)])
    if outs.shape[1] < fpc:
        outs = torch.cat([outs, outs[:, -1:].expand(-1, fpc - outs.shape[1])], 1)
    idx = stitch_index(n_chunks, fpc, hop_samples // frame_hop, n_total,
                       edge_margin_frames)
    # from pageable host memory: on the card the host waits for the queue
    with stage_timer(log, "chunking.index-upload", wait=True):
        idx_dev = torch.from_numpy(idx).to(y.device)
        count("h2d_bytes", idx.nbytes)
    return outs.reshape(-1)[idx_dev]

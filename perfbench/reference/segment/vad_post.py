"""VAD post-processing: probabilities -> speech segments.

:func:`frame_energy_db_chunk` runs on the tensor's device inside the
per-chunk program; everything else is host numpy over [F]-sized arrays
(hysteresis, morphology, energy veto, mask -> segments).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import VadConfig
from ..ops.hysteresis import hysteresis_binarize
from ..ops.morphology import morph_open_close
from ..ops.segments import mask_to_segments_host
from ..types import SegmentArray


def frame_energy_db_chunk(y: torch.Tensor, hop: int, n_extra: int = 1) -> torch.Tensor:
    """[..., T] wave -> [..., T//hop + n_extra] per-frame energy in dB
    (power re full scale); the ``n_extra`` trailing frames read -120 dB."""
    n = y.shape[-1] // hop
    yf = y[..., :n * hop].reshape(y.shape[:-1] + (n, hop))
    e = 10.0 * torch.log10(torch.mean(yf * yf, dim=-1) + 1e-12)
    if n_extra:
        pad = torch.full(e.shape[:-1] + (n_extra,), -120.0, dtype=e.dtype,
                         device=e.device)
        e = torch.cat([e, pad], dim=-1)
    return e


def vad_mask_from_probs(probs: np.ndarray, cfg: VadConfig) -> np.ndarray:
    """[T] probs -> [T] bool mask (hysteresis + morphological open/close)."""
    mask = hysteresis_binarize(probs, cfg.on_threshold, cfg.off_threshold)
    return morph_open_close(mask, cfg.hop_ms, cfg.morph_open_ms, cfg.morph_close_ms)


def apply_energy_veto(
    probs: np.ndarray, frame_energy_db: np.ndarray, cfg: VadConfig
) -> np.ndarray:
    """Zero out prob frames whose signal energy says "this cannot be speech".

    The threshold is RELATIVE — ``cfg.energy_floor_db`` below the 95th
    percentile of frame energy over frames the net is confident about
    (p >= on_threshold) — and only sustained low-energy runs
    (>= ``energy_veto_min_ms``) are vetoed, so stop closures survive.
    """
    if cfg.energy_floor_db is None:
        return probs
    probs = np.asarray(probs, np.float32)
    e = np.full(len(probs), -120.0, np.float32)
    m = min(len(probs), len(frame_energy_db))
    e[:m] = np.asarray(frame_energy_db, np.float32)[:m]
    confident = probs >= cfg.on_threshold
    if not confident.any():
        return probs
    thr = float(np.percentile(e[confident], 95.0)) + cfg.energy_floor_db
    low = e < thr
    if not low.any():
        return probs
    min_run = max(1, int(round(cfg.energy_veto_min_ms / cfg.hop_ms)))
    x = low.astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate(([0], x, [0]))))
    starts, ends = edges[::2], edges[1::2]
    out = probs.copy()
    for a, b in zip(starts, ends):
        if b - a >= min_run:
            out[a:b] = 0.0
    return out


def vad_segments_from_probs(
    probs, cfg: VadConfig | None = None, frame_energy_db=None
) -> SegmentArray:
    """Host probs -> padded speech segments; ``frame_energy_db`` (same 10 ms
    grid) enables the energy-floor veto."""
    cfg = cfg or VadConfig()
    probs = np.asarray(probs, np.float32)
    if frame_energy_db is not None and cfg.energy_floor_db is not None:
        probs = apply_energy_veto(probs, np.asarray(frame_energy_db), cfg)
    mask = vad_mask_from_probs(probs, cfg)
    return mask_to_segments_host(
        mask,
        hop_ms=cfg.hop_ms,
        min_speech_ms=cfg.min_speech_ms,
        min_gap_ms=cfg.min_silence_ms,
        speech_pad_ms=cfg.speech_pad_ms,
    )

"""Core value types shared across the framework.

The reference keeps segments as a plain dataclass (``anti_stick_diarize.py:21-26``)
plus ad-hoc ``(start, end, speaker)`` tuples (``diarization_baseline.py:259-261``).
We unify on one :class:`Segment` dataclass and a dense struct-of-arrays view
(:class:`SegmentArray`) so segment algebra can run vectorized (and, where useful,
on-device) instead of per-segment Python loops.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Iterable, Sequence

import numpy as np


@dataclass
class Segment:
    """A contiguous span of audio, optionally labeled with a speaker id.

    Mirrors the reference's ``Segment`` (``anti_stick_diarize.py:21-26``).
    Times are in seconds; ``spk`` is an integer cluster/speaker id (``-1`` or
    ``None`` meaning unassigned/noise).
    """

    start: float
    end: float
    spk: int | None = None
    score: float | None = None

    @property
    def duration(self) -> float:
        return self.end - self.start

    def with_spk(self, spk: int) -> "Segment":
        return replace(self, spk=spk)


class SegmentArray:
    """Struct-of-arrays view over a list of segments (vectorized algebra).

    ``starts``/``ends`` are float64 seconds, ``spks`` int32 (``-1`` = unassigned).
    """

    __slots__ = ("starts", "ends", "spks")

    def __init__(self, starts: np.ndarray, ends: np.ndarray, spks: np.ndarray | None = None):
        self.starts = np.asarray(starts, dtype=np.float64)
        self.ends = np.asarray(ends, dtype=np.float64)
        if spks is None:
            spks = np.full(self.starts.shape, -1, dtype=np.int32)
        self.spks = np.asarray(spks, dtype=np.int32)
        if not (self.starts.shape == self.ends.shape == self.spks.shape):
            raise ValueError("starts/ends/spks must have identical shapes")

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_segments(cls, segs: Iterable[Segment]) -> "SegmentArray":
        segs = list(segs)
        starts = np.array([s.start for s in segs], dtype=np.float64)
        ends = np.array([s.end for s in segs], dtype=np.float64)
        spks = np.array(
            [(-1 if s.spk is None else int(s.spk)) for s in segs], dtype=np.int32
        )
        return cls(starts, ends, spks)

    @classmethod
    def from_pairs(cls, pairs: Sequence[tuple[float, float]]) -> "SegmentArray":
        if len(pairs) == 0:
            return cls(np.empty(0), np.empty(0))
        arr = np.asarray(pairs, dtype=np.float64)
        return cls(arr[:, 0], arr[:, 1])

    # -- views --------------------------------------------------------------
    def to_segments(self) -> list[Segment]:
        return [
            Segment(float(s), float(e), None if k < 0 else int(k))
            for s, e, k in zip(self.starts, self.ends, self.spks)
        ]

    def __len__(self) -> int:
        return int(self.starts.shape[0])

    def __iter__(self):
        return iter(self.to_segments())

    def sort(self) -> "SegmentArray":
        order = np.lexsort((self.ends, self.starts))
        return SegmentArray(self.starts[order], self.ends[order], self.spks[order])

    @property
    def durations(self) -> np.ndarray:
        return self.ends - self.starts

    def total_duration(self) -> float:
        return float(np.sum(self.durations))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"SegmentArray(n={len(self)}, total={self.total_duration():.2f}s)"

"""Export writers: RTTM, JSON, SRT, CSV.

Mirrors ``save_json/srt/csv`` (``diar_diag.py:252-272``), RTTM export
(``diarization_baseline.py:263-266``) and the ``SPK_i`` relabeling
(``diar_diag.py:414-416``).
"""
from __future__ import annotations

import csv
import json
from pathlib import Path

from ..types import SegmentArray


def relabel_speakers(segs: SegmentArray, prefix: str = "SPK_") -> list[dict]:
    """SegmentArray -> list of {start, end, speaker} dicts with speaker ids
    renumbered 0..K-1 in order of numeric label (HDBSCAN labels may skip)."""
    uniq = sorted({int(k) for k in segs.spks if k >= 0})
    remap = {k: i for i, k in enumerate(uniq)}
    out = []
    for s, e, k in zip(segs.starts, segs.ends, segs.spks):
        name = f"{prefix}{remap[int(k)]}" if k >= 0 else f"{prefix}noise"
        out.append({"start": round(float(s), 3), "end": round(float(e), 3),
                    "speaker": name})
    return out


def write_rttm(path: str | Path, segs: SegmentArray, uri: str = "audio") -> None:
    """NIST RTTM v1.3 SPEAKER lines."""
    entries = relabel_speakers(segs)
    with open(path, "w", encoding="utf-8") as f:
        for seg in entries:
            dur = seg["end"] - seg["start"]
            f.write(
                f"SPEAKER {uri} 1 {seg['start']:.3f} {dur:.3f} "
                f"<NA> <NA> {seg['speaker']} <NA> <NA>\n"
            )


def save_json(path: str | Path, segs: SegmentArray) -> None:
    entries = relabel_speakers(segs)
    speakers = sorted({e["speaker"] for e in entries})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"segments": entries, "speakers": speakers}, f,
                  ensure_ascii=False, indent=2)


def _srt_timestamp(ts: float) -> str:
    h = int(ts // 3600)
    m = int((ts % 3600) // 60)
    s = int(ts % 60)
    ms = int(round((ts - int(ts)) * 1000))
    if ms == 1000:  # guard float rounding at the second boundary
        s, ms = s + 1, 0
    return f"{h:02d}:{m:02d}:{s:02d},{ms:03d}"


def save_srt(path: str | Path, segs: SegmentArray) -> None:
    entries = relabel_speakers(segs)
    with open(path, "w", encoding="utf-8") as f:
        for i, seg in enumerate(entries, 1):
            f.write(f"{i}\n{_srt_timestamp(seg['start'])} --> "
                    f"{_srt_timestamp(seg['end'])}\n{seg['speaker']}\n\n")


def save_csv(path: str | Path, segs: SegmentArray) -> None:
    entries = relabel_speakers(segs)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["start", "end", "speaker"])
        w.writeheader()
        w.writerows(entries)


def parse_rttm(path: str | Path) -> SegmentArray:
    """Read SPEAKER lines back into a SegmentArray; speaker names become
    contiguous ints in order of first appearance."""
    import numpy as np

    starts, ends, names = [], [], []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 8 and parts[0] == "SPEAKER":
                starts.append(float(parts[3]))
                ends.append(float(parts[3]) + float(parts[4]))
                names.append(parts[7])
    ids: dict[str, int] = {}
    spks = [ids.setdefault(n, len(ids)) for n in names]
    return SegmentArray(np.array(starts), np.array(ends),
                        np.array(spks, dtype=np.int32))

"""Recursive audio discovery for the batch subcommands (the JAX package's
``io/walk.py``)."""
from __future__ import annotations

from pathlib import Path

AUDIO_EXTS = {".wav", ".flac", ".mp3", ".m4a", ".ogg", ".opus", ".aac", ".mka", ".webm"}


def expand_audios(root: str | Path) -> tuple[list[Path], Path]:
    """File -> ([file], its parent); directory -> (the sorted audio files
    under it, the directory)."""
    root = Path(root)
    if root.is_file():
        root = root.resolve()
        return [root], root.parent
    audios = sorted(p for p in root.rglob("*.*")
                    if p.is_file() and p.suffix.lower() in AUDIO_EXTS)
    return audios, root

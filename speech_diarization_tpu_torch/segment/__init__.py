from .embed import segment_embeddings_from_grid, window_starts
from .merge import conservative_merge, merge_adjacent
from .scd import scd_split
from .vad_post import (
    apply_energy_veto,
    frame_energy_db_chunk,
    vad_segments_from_probs,
)

__all__ = [
    "apply_energy_veto",
    "conservative_merge",
    "frame_energy_db_chunk",
    "merge_adjacent",
    "scd_split",
    "segment_embeddings_from_grid",
    "vad_segments_from_probs",
    "window_starts",
]

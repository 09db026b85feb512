from .embed import (
    embed_segments_bucketed,
    embed_windows,
    embed_windows_streaming,
    segment_embeddings_from_grid,
    segment_overlap_weights,
    window_starts,
)
from .merge import (
    adjust_segment_boundaries,
    conservative_merge,
    filter_short_segments,
    merge_adjacent,
    merge_same_speaker,
)
from .overlap import (
    add_overlap_segments,
    detect_overlap_regions,
    make_seg_hard_fn,
    regions_from_hard_acts,
)
from .reassign import frame_reassign, speaker_centroids
from .scd import scd_split
from .vad_post import (
    apply_energy_veto,
    frame_energy_db_chunk,
    vad_segments_from_probs,
)

__all__ = [
    "add_overlap_segments",
    "adjust_segment_boundaries",
    "apply_energy_veto",
    "conservative_merge",
    "detect_overlap_regions",
    "embed_segments_bucketed",
    "embed_windows",
    "embed_windows_streaming",
    "frame_energy_db_chunk",
    "filter_short_segments",
    "frame_reassign",
    "make_seg_hard_fn",
    "merge_adjacent",
    "merge_same_speaker",
    "regions_from_hard_acts",
    "scd_split",
    "segment_embeddings_from_grid",
    "segment_overlap_weights",
    "speaker_centroids",
    "vad_segments_from_probs",
    "window_starts",
]

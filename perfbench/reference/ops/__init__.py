"""Algorithmic primitives (hysteresis, morphology, peaks, Viterbi,
mask <-> segments), the kernels' build and launch counters (``kernels``)
and their analytic work (``cost``).  Importing this package builds and
loads no kernel."""
from .hysteresis import hysteresis_binarize
from .morphology import binary_closing, binary_opening, morph_open_close
from .peaks import find_peaks_zscore
from .segments import mask_to_segments_host, segments_to_mask
from .viterbi import sticky_transition_logits, viterbi_decode

__all__ = [
    "hysteresis_binarize",
    "binary_opening",
    "binary_closing",
    "morph_open_close",
    "find_peaks_zscore",
    "viterbi_decode",
    "sticky_transition_logits",
    "mask_to_segments_host",
    "segments_to_mask",
]

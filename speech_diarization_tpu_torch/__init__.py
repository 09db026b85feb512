"""speech_diarization_tpu_torch — the PyTorch + CUDA port of the flagship
speaker diarizer, for one NVIDIA H100.

Mirrors the module layout of the JAX package ``speech_diarization_tpu`` (the
reference, which stays untouched) so that every module here has a
counterpart of the same name there.  Plain tensor code is PyTorch; the two
Pallas kernels of the reference are hand-written CUDA kernels for Hopper
(``csrc/``), built with ``nvcc`` at first use and loaded through ``ctypes``
(``ops/kernels.py``).  This package imports neither ``jax`` nor the JAX
package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``--cpu`` on the CLI); with no GPU and no CPU request they raise.
"""

__version__ = "0.1.0"

from .config import (
    AudioConfig,
    ClusterConfig,
    DiarizationConfig,
    EmbedConfig,
    EnhanceConfig,
    MergeConfig,
    OverlapConfig,
    ResegConfig,
    ScdConfig,
    ShardingConfig,
    StemsConfig,
    VadConfig,
    config_from_dict,
    config_to_dict,
)
from .types import Segment, SegmentArray

__all__ = [
    "__version__",
    "AudioConfig",
    "ClusterConfig",
    "DiarizationConfig",
    "EmbedConfig",
    "EnhanceConfig",
    "MergeConfig",
    "OverlapConfig",
    "ResegConfig",
    "ScdConfig",
    "ShardingConfig",
    "StemsConfig",
    "VadConfig",
    "config_from_dict",
    "config_to_dict",
    "Segment",
    "SegmentArray",
]

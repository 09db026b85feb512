"""Unified, unit-consistent configuration schema.

A copy of the JAX package's schema, field for field and default for
default, so that a config written for one package hydrates the other.
Every duration field carries its unit (``_s`` seconds, ``_ms``
milliseconds); every entry point hydrates the same frozen dataclasses by
keyword.  The port reads the fields of the stages it runs;
``ShardingConfig`` (the JAX package's device mesh) is kept for the schema
and read by none of them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class AudioConfig:
    """Audio I/O and preprocessing."""

    sample_rate: int = 16000
    target_lufs: float | None = -18.0  # loudness normalization target; None = off
    preemphasis: float | None = 0.97   # pre-emphasis coefficient; None = off
    remove_dc: bool = True


@dataclass(frozen=True)
class VadConfig:
    """VAD scoring and post-processing."""

    win_ms: float = 30.0
    hop_ms: float = 10.0
    on_threshold: float = 0.6
    off_threshold: float = 0.4
    morph_open_ms: float = 80.0
    morph_close_ms: float = 40.0
    min_speech_ms: float = 250.0
    min_silence_ms: float = 100.0
    speech_pad_ms: float = 40.0
    batch_frames: int = 8192
    # Energy-floor veto: frames this many dB below the file's speech level
    # (95th-percentile frame energy over net-confident frames) cannot be
    # speech, whatever the net says: the conv TCN's receptive field leaks
    # probability into short digital-silence gaps.  None disables.
    energy_floor_db: float | None = -45.0
    # only runs at least this long are vetoed, so stop closures survive
    energy_veto_min_ms: float = 150.0


@dataclass(frozen=True)
class ScdConfig:
    """Speaker-change detection on the grid embeddings."""

    enabled: bool = True
    win_ms: float = 1000.0
    hop_ms: float = 200.0
    # over-segmentation is benign (same-speaker merging stitches the atoms
    # back); a missed change is not (an impure segment cannot be fixed later)
    peak_z_threshold: float = 1.0
    min_speech_ms: float = 1000.0


@dataclass(frozen=True)
class EmbedConfig:
    """Speaker-embedding extraction: ``mode='grid'`` (segment embeddings as
    masked means over the window grid) or ``'bucketed'`` (each segment's own
    snippet through the per-utterance encoder, in power-of-two length
    buckets of ``batch_size`` snippets at most 32)."""

    backend: str = "ecapa"
    dim: int = 192
    mode: str = "grid"                # grid | bucketed
    grid_backend: str = "auto"        # auto | streaming | windowed
    # the flagship's grid geometry comes from ResegConfig.win_s/hop_s; these
    # two parameterize only the standalone segment-embedding helpers
    grid_win_s: float = 1.5
    grid_hop_s: float = 0.75
    min_duration_ms: float = 500.0
    pad_duration_ms: float = 150.0
    batch_size: int = 512
    max_batch_size: int = 1024
    whiten: bool = False
    dtype: str = "bfloat16"


@dataclass(frozen=True)
class ClusterConfig:
    """Clustering.  The port runs ``method='spectral'``."""

    method: str = "spectral"          # the copy holds spectral alone
    min_speakers: int = 1
    max_speakers: int = 8
    cos_threshold: float = 0.70
    min_cluster_size: int = 2
    p_percentile: float = 0.90
    asnorm: bool = False
    asnorm_topk: int = 200
    # window-driven recursive cluster bisection after clustering
    # (cluster/spectral.refine_labels_by_windows)
    refine_splits: bool = True
    # bisection split threshold: None = the encoder's calibrated value (npz
    # meta ``refine_sub_cos``), else the built-in default; a float overrides
    # both; a value <= 0 disables the refine stage
    refine_sub_cos: float | None = None
    # the refine statistics were calibrated on clean audio: with an SNR
    # estimate below this floor the refine stage is skipped; None = no gate
    refine_min_snr_db: float | None = 25.0


@dataclass(frozen=True)
class ResegConfig:
    """Frame-level reassignment, and the dense grid's geometry: ``win_s``
    and ``hop_s`` serve SCD, segment embeddings and reassignment alike.
    Reassignment is off by default (``enabled``)."""

    enabled: bool = False
    win_s: float = 2.0
    hop_s: float = 0.1
    hmm: bool = False
    hmm_self_loop: float = 0.995
    adjacent_gap_s: float = 0.05


@dataclass(frozen=True)
class MergeConfig:
    """Segment merges and boundary ops."""

    max_gap_s: float = 0.5
    max_turn_s: float = 30.0
    min_cos: float = 0.80
    boundary_pad_s: float = 0.04
    min_speech_s: float = 0.0


@dataclass(frozen=True)
class StemsConfig:
    """Per-speaker stem extraction."""

    max_segment_s: float = 20.0
    max_gap_s: float = 1.5
    fade_ms: float = 20.0
    min_stem_s: float = 3.0


@dataclass(frozen=True)
class EnhanceConfig:
    """Speech-enhancement front-end.  With ``scope='auto'`` it engages only
    when the file's estimated SNR (p95/p05 of 50 ms frame energies) is below
    ``auto_snr_db``."""

    enabled: bool = True
    backend: str = "gtcrn"            # gtcrn | zipenhancer
    scope: str = "auto"               # auto | vad | full
    auto_snr_db: float = 25.0
    auto_route_demix: bool = True
    babble_floor_hf_frac: float = 0.25
    weights: str | None = None
    chunk_s: float = 360.0
    overlap_s: float = 1.0
    window_s: float = 2.0
    hop_ratio: float = 0.75
    batch_size: int = 64


@dataclass(frozen=True)
class ShardingConfig:
    """Device mesh axes of the JAX package (unused by the port)."""

    data_axis: str = "dp"
    model_axis: str = "tp"
    dp: int = -1
    tp: int = 1


@dataclass(frozen=True)
class OverlapConfig:
    """Overlap rescue: a segmentation model marks where two people speak at
    once, and each such region gains one second-speaker segment."""

    enabled: bool = True
    weights: str | None = None
    chunk_s: float = 5.0
    chunk_hop_s: float = 2.5
    min_on_s: float = 0.3
    min_gap_s: float = 0.15
    min_cos: float = 0.10
    max_overlap_frac: float = 0.5
    min_snr_db: float | None = 25.0


@dataclass(frozen=True)
class DiarizationConfig:
    """Top-level config: the single source of truth for all pipelines."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    vad: VadConfig = field(default_factory=VadConfig)
    scd: ScdConfig = field(default_factory=ScdConfig)
    embed: EmbedConfig = field(default_factory=EmbedConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    reseg: ResegConfig = field(default_factory=ResegConfig)
    merge: MergeConfig = field(default_factory=MergeConfig)
    stems: StemsConfig = field(default_factory=StemsConfig)
    enhance: EnhanceConfig = field(default_factory=EnhanceConfig)
    overlap: OverlapConfig = field(default_factory=OverlapConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)


def _hydrate(cls, data: Mapping[str, Any]):
    """Strict keyword hydration: unknown keys raise, wrong nesting raises."""
    if not dataclasses.is_dataclass(cls):
        return data
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        factory = fields[name].default_factory
        if isinstance(value, Mapping) and factory is not dataclasses.MISSING:
            kwargs[name] = _hydrate(factory, value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


def config_from_dict(data: Mapping[str, Any]) -> DiarizationConfig:
    """Build a :class:`DiarizationConfig` from a (possibly nested) dict, strictly."""
    return _hydrate(DiarizationConfig, data)


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)

"""Batch Diarizer with stems export: the pyannote-scaffold pipeline's mirror
(the JAX package's ``pipelines/baseline.py``).

Capability mirror of ``diarization_baseline.Diarizer``
(``diarization_baseline.py:283-346``) and its batch CLI ``main``
(``diarization_baseline.py:349-376``): min/max-speaker bounded clustering,
short-segment filter, same-speaker merging, boundary padding into silence,
RTTM export, per-speaker stems, skip-if-output-exists resume over directory
trees.  The engine is the flagship pipeline (AHC, 2-6 speakers at cos 0.70
by default) or the segmentation engine (``pipelines/segmentation.py``).
"""
from __future__ import annotations

from pathlib import Path

from ..config import ClusterConfig, DiarizationConfig
from ..io.audio import read_audio
from ..io.stems import extract_speaker_stems
from ..io.walk import expand_audios
from ..io.writers import write_rttm
from ..segment.merge import (
    adjust_segment_boundaries,
    filter_short_segments,
    merge_same_speaker,
)
from ..types import SegmentArray
from ..utils.logging import get_logger
from .diarize import DiarizationPipeline

log = get_logger("baseline")


class Diarizer:
    """Batch wav -> (segments, stems) processor.

    ``engine='flagship'`` (default) runs the VAD+SCD+cluster pipeline;
    ``engine='segmentation'`` runs the chunk-local speaker-activity engine
    (overlap-aware) with the first shipped checkpoint of
    ``ENGINE_SEGMENTATION_PREFERENCE`` (or ``seg_weights``).  Without one it
    warns and runs a net of random weights from a seeded generator.
    ``pipeline_kwargs`` go to :class:`DiarizationPipeline` (``encoder``,
    ``vad``, ``device``); the engine runs on the pipeline's device."""

    def __init__(self, cfg: DiarizationConfig | None = None,
                 engine: str = "flagship",
                 seg_weights: str | Path | None = None,
                 **pipeline_kwargs):
        if engine not in ("flagship", "segmentation"):
            raise ValueError(f"unknown engine {engine!r}")
        if cfg is None:
            cfg = DiarizationConfig(
                cluster=ClusterConfig(method="ahc", min_speakers=2, max_speakers=6,
                                      cos_threshold=0.70),
            )
        self.cfg = cfg
        self.engine = engine
        self.pipeline = DiarizationPipeline(cfg, **pipeline_kwargs)
        if engine == "segmentation":
            from ..models.port import load_segmentation
            from ..models.segmentation import SegmentationModel, SegNet, seeded_init
            from ..utils.weights import (
                ENGINE_SEGMENTATION_PREFERENCE, WEIGHTS_ROOT, prefer_weights,
            )
            from .segmentation import SegmentationConfig, make_seg_activities_fn

            seg_weights = seg_weights or prefer_weights(
                ENGINE_SEGMENTATION_PREFERENCE
            ) or WEIGHTS_ROOT / "segmentation_synthetic.npz"
            if Path(seg_weights).exists():
                model = load_segmentation(seg_weights)
            else:
                log.warning(
                    "segmentation engine: %s missing: RANDOM weights, "
                    "activities will be meaningless", seg_weights)
                model = SegmentationModel(seeded_init(SegNet(), 0))
            self.seg_model = model.to(self.pipeline.device).eval()
            # dual soft+hard scorer: powerset checkpoints binarize on the
            # argmax decode
            self._seg_fn = make_seg_activities_fn(self.seg_model)
            self._seg_cfg = SegmentationConfig(
                cos_threshold=cfg.cluster.cos_threshold,
                min_speakers=cfg.cluster.min_speakers or 1,
                max_speakers=cfg.cluster.max_speakers or 8,
                merge_gap_s=cfg.merge.max_gap_s,
            )

    def diarize(self, source, rttm_path: str | Path | None = None) -> SegmentArray:
        """Segments with min-duration filter + time sort
        (``Diarizer.diarize``, ``diarization_baseline.py:289-303``)."""
        if self.engine == "segmentation":
            from .segmentation import segmentation_diarize

            y, sr = read_audio(source, target_sr=self.cfg.audio.sample_rate,
                               mono=True)
            segs = segmentation_diarize(
                y, sr, self._seg_fn, self.pipeline.encode_fn, self._seg_cfg)
        else:
            segs = self.pipeline(source).segments
        segs = filter_short_segments(segs, self.cfg.merge.min_speech_s)
        segs = segs.sort()
        if rttm_path is not None:
            write_rttm(rttm_path, segs)
        return segs

    def merge_segments(self, segs: SegmentArray) -> SegmentArray:
        return merge_same_speaker(
            segs, self.cfg.stems.max_gap_s, self.cfg.stems.max_segment_s
        )

    def pad_segments(self, segs: SegmentArray) -> SegmentArray:
        return adjust_segment_boundaries(
            segs, padding_s=self.cfg.stems.fade_ms * 2 / 1000.0
        )

    def extract_speakers(
        self, segs: SegmentArray, source, root: str | Path, stem_name: str = "audio"
    ) -> dict:
        y, sr = read_audio(source, target_sr=self.cfg.audio.sample_rate, mono=True)
        st = self.cfg.stems
        return extract_speaker_stems(
            y, sr, segs, root,
            max_segment_s=st.max_segment_s, max_gap_s=st.max_gap_s,
            fade_ms=st.fade_ms, min_stem_s=st.min_stem_s, stem_name=stem_name,
        )

    def __call__(
        self, audio_path: str | Path, root: str | Path, with_rttm: bool = False
    ) -> tuple[SegmentArray, dict]:
        audio_path = Path(audio_path)
        rttm = audio_path.with_suffix(".rttm") if with_rttm else None
        segs = self.diarize(audio_path, rttm)
        segs = self.merge_segments(segs)
        segs = self.pad_segments(segs)
        info = self.extract_speakers(segs, audio_path, root, stem_name=audio_path.stem)
        return segs, info


def run_batch(
    root: str | Path,
    cfg: DiarizationConfig | None = None,
    with_rttm: bool = True,
    engine: str = "flagship",
    **pipeline_kwargs,
) -> list[tuple[Path, int]]:
    """Directory batch with skip-if-done resume
    (``diarization_baseline.py:370-376``): a file whose ``.rttm`` already
    exists is skipped, and audio under a ``*-speakers`` directory (the stems
    of an earlier run) is not taken in again."""
    diarizer = Diarizer(cfg, engine=engine, **pipeline_kwargs)
    audios, aroot = expand_audios(Path(root))
    audios = [a for a in audios
              if not any(part.endswith("-speakers") for part in a.parts)]
    log.info("batch: %d files under %s", len(audios), aroot)
    done = []
    for apath in audios:
        if apath.with_suffix(".rttm").exists():
            log.info("skip (rttm exists): %s", apath)
            continue
        troot = apath.with_name(f"{apath.stem}-speakers")
        segs, _ = diarizer(apath, troot, with_rttm)
        log.info("%s -> %d segments", apath, len(segs))
        done.append((apath, len(segs)))
    return done

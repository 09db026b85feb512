"""End-to-end pipelines: the flagship streamed diarizer (``diarize``), the
batch ``Diarizer`` with stems (``baseline``), the segmentation engine, the
diagnostic harness, the enhancement and demix front-ends and the corpus
worker.  The package exports what the JAX package's ``pipelines`` does."""
from .diarize import DiarizationPipeline, DiarizationResult, diarize

__all__ = ["DiarizationPipeline", "DiarizationResult", "diarize"]

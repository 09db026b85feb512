"""Evaluation metrics: DER and JER."""
from .der import DerBreakdown, diarization_error_rate, jaccard_error_rate

__all__ = ["diarization_error_rate", "jaccard_error_rate", "DerBreakdown"]

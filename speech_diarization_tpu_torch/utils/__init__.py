"""Shared utilities: structured logging, stage timing, profiling."""
from .logging import get_logger, stage_timer
from .profiling import Profiler, count_params, model_complexity

__all__ = ["get_logger", "stage_timer", "Profiler", "model_complexity", "count_params"]

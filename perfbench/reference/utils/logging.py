"""Structured logging + stage timers.

The reference observes progress with ad-hoc ``rich.track`` bars and bare
prints (SURVEY.md §5 'Metrics / logging'); here every pipeline stage logs a
named, timed record through the standard logging machinery so runs are
scriptable and diffable.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"sdtpu.{name}")
    if not logging.getLogger("sdtpu").handlers:
        root = logging.getLogger("sdtpu")
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(os.environ.get("SDTPU_LOG_LEVEL", "WARNING").upper())
        root.propagate = False
    return logger


@contextlib.contextmanager
def stage_timer(logger: logging.Logger, stage: str):
    """Log wall time of a pipeline stage at INFO."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.info("stage=%s wall_s=%.3f", stage, time.perf_counter() - t0)

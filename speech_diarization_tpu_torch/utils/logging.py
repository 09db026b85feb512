"""Structured logging, stage timers and the spans behind them.

The reference observes progress with ad-hoc ``rich.track`` bars and bare
prints (SURVEY.md §5 'Metrics / logging'); here every pipeline stage logs a
named, timed record through the standard logging machinery so runs are
scriptable and diffable.

The same :func:`stage_timer` is the program's one span recorder.  Its log
record never changes (``stage=<name> wall_s=<s>`` at INFO; readers take the
unrounded seconds from the record's ``args``).  While a
:class:`SpanRecorder` is installed (:func:`recording`, or a reader setting
:data:`RECORDER`) each stage also leaves a :class:`Span` in memory: its
parent, the file it belongs to (:func:`file_scope`), its start and end on
the profiler's clock, its counters (:func:`count`) and, for a
``device=True`` stage, the CUDA-event time of the card's stream.  While a
``torch.profiler`` session is active each stage is also a
``record_function`` range, so a Chrome trace shows the host stages over the
kernels.  Nothing is written to disk.
"""
from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time

import torch

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"

# The installed SpanRecorder, or None (the default: stages keep no record).
# One slot for the process, since stage_timer's callers pass no recorder.
RECORDER: SpanRecorder | None = None
_FILE = threading.local()        # .id: the file id of this thread's stages


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


class Span:
    """One recorded stage.  ``parent``: the ``id`` of the stage open
    around it on the same thread, or None; ``file``: the id of
    :func:`file_scope` around it, or None; ``start_ns`` / ``end_ns``:
    Unix-epoch nanoseconds, the clock of ``torch.profiler`` events'
    ``start_ns()`` (``end_ns`` None while open); ``wait``: the host blocks
    on a device result inside it; ``device_ms``: the card's stream time
    between the span's CUDA events, after :meth:`SpanRecorder.resolve`;
    ``counts``: what :func:`count` added inside it, or None."""

    __slots__ = ("id", "name", "parent", "file", "start_ns", "end_ns", "wait",
                 "device_ms", "counts", "events")

    def __init__(self, id_: int, name: str, parent: int | None, file: int | None,
                 start_ns: int, wait: bool):
        self.id = id_
        self.name = name
        self.parent = parent
        self.file = file
        self.start_ns = start_ns
        self.end_ns: int | None = None
        self.wait = wait
        self.device_ms: float | None = None
        self.counts: dict[str, int] | None = None
        self.events = None

    @property
    def wall_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"file={self.file}, wait={self.wait})")


class SpanRecorder:
    """Keeps a :class:`Span` of every stage, in the order they open, while
    it is :data:`RECORDER`.  Each thread keeps its own stack of open
    stages, so the spans of concurrent workers never parent each other."""

    def __init__(self) -> None:
        self.spans: list[Span] = []
        self._ids = itertools.count()
        self._local = threading.local()
        # perf_counter_ns read on the profiler's (Unix-epoch) clock
        self._epoch_minus_perf = time.time_ns() - time.perf_counter_ns()

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, t0_perf_ns: int, wait: bool, device: bool) -> Span:
        stack = self._stack()
        sp = Span(next(self._ids), name, stack[-1].id if stack else None,
                  current_file(), t0_perf_ns + self._epoch_minus_perf,
                  wait)
        if device:
            sp.events = (torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
            sp.events[0].record()
        stack.append(sp)
        self.spans.append(sp)
        return sp

    def close(self, sp: Span, t1_perf_ns: int) -> None:
        if sp.events is not None:
            sp.events[1].record()
        sp.end_ns = t1_perf_ns + self._epoch_minus_perf
        self._stack().remove(sp)

    def resolve(self) -> None:
        """Read every closed ``device=True`` span's CUDA events into
        ``device_ms`` (waits for the card to pass them)."""
        for sp in self.spans:
            if sp.events is not None and sp.end_ns is not None:
                sp.events[1].synchronize()
                sp.device_ms = float(sp.events[0].elapsed_time(sp.events[1]))
                sp.events = None

    def by_id(self) -> dict[int, Span]:
        return {sp.id: sp for sp in self.spans}


@contextlib.contextmanager
def recording(recorder: SpanRecorder | None = None):
    """Install ``recorder`` (a new one by default) as :data:`RECORDER` for
    the block and yield it; the one installed before comes back after."""
    global RECORDER
    rec = SpanRecorder() if recorder is None else recorder
    prev, RECORDER = RECORDER, rec
    try:
        yield rec
    finally:
        RECORDER = prev


@contextlib.contextmanager
def file_scope(file_id: int | None):
    """Every stage this thread opens in the block belongs to ``file_id``."""
    prev = getattr(_FILE, "id", None)
    _FILE.id = file_id
    try:
        yield
    finally:
        _FILE.id = prev


def current_file() -> int | None:
    """The file id of :func:`file_scope` around this thread, or None."""
    return getattr(_FILE, "id", None)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of this thread's innermost open stage
    (nothing while no recorder is installed)."""
    rec = RECORDER
    if rec is None:
        return
    stack = rec._stack()
    if stack:
        sp = stack[-1]
        if sp.counts is None:
            sp.counts = {}
        sp.counts[name] = sp.counts.get(name, 0) + n


@contextlib.contextmanager
def stage_timer(logger: logging.Logger, stage: str, *, wait: bool = False,
                device: bool = False):
    """Log wall time of a pipeline stage at INFO.

    ``wait``: the host blocks on a device result inside the stage.
    ``device``: while recording, CUDA events around the stage (give it only
    for work queued on the card).  With no recorder installed and no
    profiler running, the stage costs the timer and the log call alone."""
    rec = RECORDER
    rf = None
    if torch.autograd._profiler_enabled():
        rf = torch.profiler.record_function(stage)
        rf.__enter__()
    t0 = time.perf_counter_ns()
    sp = rec.open(stage, t0, wait, device) if rec is not None else None
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        if sp is not None:
            rec.close(sp, t1)
        if rf is not None:
            rf.__exit__(None, None, None)
        logger.info("stage=%s wall_s=%.3f", stage, (t1 - t0) * 1e-9)

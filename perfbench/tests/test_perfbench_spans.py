"""The readers of the port's own spans (``copy_wait_ms_per_min``,
``chunk_launch_ms_per_min``, ``host_syncs_per_file``) on a synthetic
traced window: spans outside the window are dropped, waits are counted
once and grouped by file, and nothing to read gives None."""
from __future__ import annotations

import importlib
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import spec  # noqa: E402
from perfbench.harness.trace import TraceContext  # noqa: E402

port_logging = importlib.import_module("speech_diarization_tpu_torch.utils.logging")
READERS = ("copy_wait_ms_per_min", "chunk_launch_ms_per_min", "host_syncs_per_file")
MS = 1_000_000


def _ctx() -> TraceContext:
    ctx = TraceContext(None, None, {})
    ctx.t0, ctx.wall_minus_perf, ctx.window_s = 100.0, 1.7e9, 20.0
    ctx.audio_s = 120.0                                  # two minutes
    return ctx


def _lo(ctx) -> int:
    return round((ctx.t0 + ctx.wall_minus_perf) * 1e9)


def _add(rec, name, start_ms, end_ms, *, lo, file=None, parent=None, wait=False):
    sp = port_logging.Span(len(rec.spans), name, None if parent is None else parent.id,
                           file, lo + round(start_ms * MS), wait)
    sp.end_ns = lo + round(end_ms * MS)
    rec.spans.append(sp)
    return sp


@pytest.fixture
def window():
    """Two files in the window; spans before it and across its end."""
    ctx = _ctx()
    lo = _lo(ctx)
    rec = ctx.program_spans = port_logging.SpanRecorder()
    _add(rec, "collect.wait", -5, -4, lo=lo, file=7, wait=True)          # before
    _add(rec, "ingest.launch", -3, -1, lo=lo, file=7)
    ing = _add(rec, "ingest", 1, 50, lo=lo, file=0)
    _add(rec, "ingest.launch", 10, 30, lo=lo, file=0, parent=ing)
    col = _add(rec, "collect", 60, 62, lo=lo, file=0)
    _add(rec, "collect.wait", 60, 61, lo=lo, file=0, parent=col, wait=True)
    disp = _add(rec, "dispatch", 100, 200, lo=lo, file=1)
    vad = _add(rec, "dispatch.vad", 100, 150, lo=lo, file=1, parent=disp)
    up = _add(rec, "chunking.index-upload", 140, 143, lo=lo, file=1, parent=vad, wait=True)
    _add(rec, "inner", 141, 142, lo=lo, file=1, parent=up, wait=True)  # inside a wait
    _add(rec, "dispatch.copy", 190, 192, lo=lo, file=1, parent=disp, wait=True)
    _add(rec, "probe.wait", 300, 301, lo=lo, wait=True)                 # no file
    _add(rec, "ingest.launch", 19_990, 20_010, lo=lo, file=2)           # across the end
    _add(rec, "collect.wait", 19_995, 20_005, lo=lo, file=2, wait=True)
    return ctx


def _read(name, ctx):
    return spec.load_reader(name).read(ctx)


def test_copy_wait_sums_the_outer_waits_in_the_window(window):
    # 1 + 3 + 2 + 1 ms (the file-less wait too; the nested one once)
    assert _read("copy_wait_ms_per_min", window) == pytest.approx(7.0 / 2)


def test_chunk_launch_reads_ingest_launch_in_the_window(window):
    assert _read("chunk_launch_ms_per_min", window) == pytest.approx(20.0 / 2)


def test_host_syncs_groups_waits_by_file(window):
    # file 0: collect.wait; file 1: the index upload and the copy
    assert _read("host_syncs_per_file", window) == pytest.approx(3 / 2)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_is_none(name):
    ctx = _ctx()
    assert _read(name, ctx) is None                       # no recorder
    ctx.program_spans = port_logging.SpanRecorder()
    assert _read(name, ctx) is None                       # no span
    rec = ctx.program_spans
    _add(rec, "collect.wait", -5, -4, lo=_lo(ctx), file=0, wait=True)
    _add(rec, "ingest.launch", -3, -1, lo=_lo(ctx), file=0)
    assert _read(name, ctx) is None                       # none in the window


def test_install_shares_one_recorder_and_restore_takes_it_out():
    ctx = _ctx()
    mods = [spec.load_reader(n) for n in READERS]
    for m in mods:
        m.install(ctx)
    rec = ctx.program_spans
    assert port_logging.RECORDER is rec
    assert len(ctx._undo) == 1
    ctx.restore()
    assert port_logging.RECORDER is None and ctx.program_spans is rec


def test_a_port_without_the_recorder_installs_nothing(monkeypatch):
    """The parent commit's port: no recorder, so no reading and no error."""
    monkeypatch.delattr(port_logging, "SpanRecorder")
    ctx = _ctx()
    for n in READERS:
        mod = spec.load_reader(n)
        mod.install(ctx)
        assert mod.read(ctx) is None
    assert not ctx._undo and not hasattr(ctx, "program_spans")

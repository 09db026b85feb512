"""The port's span recorder behind ``stage_timer`` (``utils/logging.py``):
off by default and then as cheap as the timer, the log record the
benchmark reads unchanged, the span tree of a streamed and a whole-file
call with one file id a file, per-thread stacks, and the profiler's clock.

The pipeline is the shipped conv VAD and streaming ECAPA on the CPU at the
default configuration (detector on), with 10 s chunks so a 10 s file is
one chunk; the whole-file call is a noisy draw behind an injected
enhancer, so the route runs without GTCRN's cost.  The demix-dialog
front-end's spans come from the same noisy draw behind a two-net ensemble
of small seeded HTDemucs nets (depth 4 at 8 channels, 4 s chunks).
"""
from __future__ import annotations

import importlib
import logging
import sys
import threading
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import speech_diarization_tpu_torch as port
from speech_diarization_tpu_torch.models.demucs_ref import HTDemucsRef
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.models.registry import seeded_init
from speech_diarization_tpu_torch.pipelines.chunking import chunked_framewise
from speech_diarization_tpu_torch.pipelines.corpus import corpus_diarize
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn
from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout
from speech_diarization_tpu_torch.train.synthetic import make_conversation

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the module, not the ``logging`` package's name the port re-exports
lg = importlib.import_module("speech_diarization_tpu_torch.utils.logging")

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
TAIL = ("vad-post", "scd", "segment-embeddings", "cluster", "merge",
        "reassign", "overlap-rescue")
DEMIX_NET = dict(channels=8, depth=4, nfft=512, bottom_channels=16, t_layers=2,
                 t_heads=2)


@pytest.fixture(scope="module")
def pipe():
    p = DiarizationPipeline(port.DiarizationConfig(),
                            encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
                            vad=load_vad(WEIGHTS / "vad_conv_mc.npz"),
                            enhance_fn=lambda y: 0.5 * y, device="cpu")
    p._PAD_BUCKET_S = 10.0
    return p


@pytest.fixture(scope="module")
def waves():
    clean, _ = make_conversation(np.random.default_rng(3), 10.0, n_speakers=2, sr=SR)
    noisy, _ = make_conversation_heldout(np.random.default_rng(11), 10.0, n_speakers=2,
                                         sr=SR, snr_db=10.0, noise_kind="white")
    return clean.astype(np.float32), noisy.astype(np.float32)


@pytest.fixture(scope="module")
def recorded(pipe, waves):
    """One streamed and one whole-file call under a recorder: -> (spans of
    each call, their results, the streamed call's state)."""
    clean, noisy = waves
    pipe._programs.clear()          # the chunk program is built in the call
    with lg.recording() as rec:
        st = pipe.stream_start(clean)
        res_s = pipe.stream_finish(st)
        n_streamed = len(rec.spans)
        res_w = pipe(noisy)
    return rec, rec.spans[:n_streamed], rec.spans[n_streamed:], res_s, res_w, st


def _tree(spans, rec) -> set[tuple[str, str | None]]:
    by_id = rec.by_id()
    return {(s.name, by_id[s.parent].name if s.parent is not None else None)
            for s in spans}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record)


def test_recording_off_keeps_nothing_and_makes_no_cuda_event(pipe, waves):
    log = lg.get_logger("test_tracing")
    assert lg.RECORDER is None
    with mock.patch.object(torch.cuda, "Event") as event, \
            mock.patch.object(torch.cuda, "synchronize") as sync:
        with lg.stage_timer(log, "outer", device=True, wait=True):
            with lg.stage_timer(log, "inner", device=True):
                lg.count("bytes", 4)
        pipe(waves[0])
    assert event.call_count == 0 and sync.call_count == 0
    assert lg.RECORDER is None


def test_device_spans_take_cuda_events_only_while_recording():
    log = lg.get_logger("test_tracing")
    with mock.patch.object(torch.cuda, "Event") as event:
        event.return_value.elapsed_time.return_value = 2.5
        with lg.recording() as rec:
            with lg.stage_timer(log, "dev", device=True):
                pass
            with lg.stage_timer(log, "host"):
                pass
        assert event.call_count == 2
        assert event.return_value.record.call_count == 2
        rec.resolve()
    dev, host = rec.spans
    assert dev.device_ms == 2.5 and dev.events is None
    assert host.device_ms is None


@pytest.mark.parametrize("on", [False, True], ids=["off", "recording"])
def test_the_log_record_is_unchanged(on):
    """The benchmark's stage reader matches this ``msg`` and reads the
    unrounded seconds from ``args``."""
    log = lg.get_logger("test_tracing")
    handler = _Records()
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    try:
        if on:
            with lg.recording():
                with lg.stage_timer(log, "a-stage", wait=True):
                    pass
        else:
            with lg.stage_timer(log, "a-stage"):
                pass
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    (rec,) = handler.records
    assert rec.msg == "stage=%s wall_s=%.3f"
    assert isinstance(rec.args, tuple) and len(rec.args) == 2
    assert rec.args[0] == "a-stage" and type(rec.args[1]) is float
    assert rec.levelno == logging.INFO


def test_streamed_call_span_tree(recorded):
    rec, spans, _, res, _, st = recorded
    assert res.diagnostics["route"] == "streamed"
    assert _tree(spans, rec) == {
        ("ingest", None), ("ingest.quantize", "ingest"), ("ingest.upload", "ingest"),
        ("ingest.probe", "ingest"), ("ingest.program", "ingest"),
        ("ingest.launch", "ingest"), ("encoder", "ingest.launch"),
        ("ingest.pack", "ingest"), ("collect", None), ("collect.wait", "collect"),
        ("vad-post", None), ("scd", None), ("segment-embeddings", None),
        ("cluster", None), ("cluster.spectral", "cluster"),
        ("cluster.refine", "cluster"), ("merge", None), ("overlap-rescue", None)}
    assert {s.file for s in spans} == {st["file_id"]}
    assert [s.name for s in spans if s.wait] == ["collect.wait"]
    counts = {s.name: s.counts for s in spans if s.counts}
    assert counts["ingest.upload"] == {"h2d_bytes": SR * 10 * 2}
    assert counts["ingest.launch"] == {"chunks": 1}
    assert counts["ingest.program"] == {"program_builds": 1}
    assert counts["ingest.pack"]["d2h_bytes"] > 0
    assert all(s.end_ns >= s.start_ns for s in spans)


def test_whole_file_call_span_tree(recorded):
    rec, streamed, spans, _, res, _ = recorded
    assert res.diagnostics["route"] == "legacy"
    tree = _tree(spans, rec)
    assert {("load+preprocess", None), ("load.floor-probe", "load+preprocess"),
            ("enhance", "load+preprocess"), ("load.preprocess", "load+preprocess"),
            ("dispatch", None), ("dispatch.vad", "dispatch"),
            ("dispatch.grid", "dispatch"), ("encoder", "dispatch.grid"),
            ("dispatch.copy", "dispatch"), ("cluster.spectral", "cluster")} <= tree
    assert {n for n, _ in tree} >= {"ingest", "ingest.quantize", "ingest.probe"}
    # one file, not the streamed call's
    (fid,) = {s.file for s in spans}
    assert fid is not None and fid != streamed[0].file
    # a 10 s file is one VAD chunk: no stitch index to upload
    assert [s.name for s in spans if s.wait] == ["dispatch.copy"]


def test_host_tail_stages_never_nest(recorded):
    rec, streamed, whole, _, _, _ = recorded
    by_id = rec.by_id()
    for s in streamed + whole:
        p = s.parent
        while p is not None:
            assert not (s.name in TAIL and by_id[p].name in TAIL), s
            p = by_id[p].parent


def test_cluster_spans_count_one_blas_thread(recorded):
    """Both routes run the host tail on one BLAS thread: each ``cluster``
    span carries ``blas_threads`` 1."""
    _, streamed, whole, *_ = recorded
    for spans in (streamed, whole):
        cl = [s for s in spans if s.name == "cluster"]
        assert cl and all(s.counts == {"blas_threads": 1} for s in cl)


def test_the_stitch_index_upload_is_a_wait():
    y = torch.randn(20 * SR)
    with lg.recording() as rec:
        out = chunked_framewise(lambda rows: rows[:, ::160][:, :1501], y, SR,
                                frame_hop=160)
    assert out.shape == (20 * SR // 160 + 1,)
    (sp,) = rec.spans
    assert sp.name == "chunking.index-upload" and sp.wait
    assert sp.counts == {"h2d_bytes": out.shape[0] * 8}


def test_corpus_overlap_keeps_each_files_id(pipe, waves):
    """The corpus worker starts file 2 before it finishes file 1: each
    file's spans still carry that file's id."""
    with lg.recording() as rec:
        rep = corpus_diarize(list(waves), pipeline_factory=lambda: pipe)
    assert len(rep.files) == 2 and not rep.errors
    ingest = [s for s in rec.spans if s.name == "ingest"]
    assert len(ingest) == 2
    first, second = (s.file for s in ingest)
    assert first != second
    order = [s.file for s in rec.spans if s.parent is None]
    # the second file's ingest runs before the first file's tail
    assert order.index(second) < max(i for i, f in enumerate(order) if f == first)
    for fid in (first, second):
        names = {s.name for s in rec.spans if s.file == fid}
        assert {"ingest", "vad-post", "cluster"} <= names
    assert all(s.file in (first, second) for s in rec.spans)
    assert all(s.counts == {"blas_threads": 1} for s in rec.spans if s.name == "cluster")


def test_two_threads_keep_separate_stacks():
    log = lg.get_logger("test_tracing")
    barrier = threading.Barrier(2, timeout=10)

    def work(i):
        with lg.stage_timer(log, f"outer{i}"):
            barrier.wait()
            with lg.stage_timer(log, f"inner{i}"):
                lg.count("n", i + 1)
                barrier.wait()

    with lg.recording() as rec:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
    by_name = {s.name: s for s in rec.spans}
    for i in range(2):
        inner, outer = by_name[f"inner{i}"], by_name[f"outer{i}"]
        assert inner.parent == outer.id and outer.parent is None
        assert inner.counts == {"n": i + 1} and outer.counts is None


def test_spans_lie_on_the_profilers_clock():
    """A range opened inside a stage lies within the stage's interval on
    the profiler's clock, within 1 ms; the stage is a range of its own."""
    log = lg.get_logger("test_tracing")
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof, lg.recording() as rec:
        with lg.stage_timer(log, "a-stage"):
            with record_function("inside"):
                for _ in range(20):
                    x = torch.tanh(x @ x)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name() in ("inside", "a-stage")}
    (sp,) = rec.spans
    inside = events["inside"]
    start, end = inside.start_ns(), inside.start_ns() + inside.duration_ns()
    assert sp.start_ns - 1_000_000 <= start <= end <= sp.end_ns + 1_000_000
    assert end - start > 0
    assert "a-stage" in events


# -------------------------------------------------- demix-dialog front-end --
DEMIX_TREE = {
    ("demix.download", "enhance"), ("demix.resample-in", "enhance"),
    ("demix.upload", "enhance"), ("demix.separate", "enhance"),
    ("demix.encode", "demix.separate"), ("demix.transformer", "demix.separate"),
    ("demix.decode", "demix.separate"), ("demix.ola", "enhance"),
    ("demix.fetch", "enhance"), ("demix.resample-out", "enhance"),
    ("demix.return", "enhance")}


def _demix_fn():
    nets = [seeded_init(HTDemucsRef(**DEMIX_NET), s) for s in (0, 1)]
    return make_enhance_fn("demix-dialog", device="cpu", nets=nets, chunk_s=4.0)


@pytest.fixture(scope="module")
def demix_recorded(waves):
    """The noisy draw through the demix-dialog front-end, whole-file route,
    under a recorder: -> (recorder, its spans of the demixer, result)."""
    cfg = port.config_from_dict({"enhance": {"backend": "demix-dialog"}})
    p = DiarizationPipeline(cfg, encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
                            vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), enhance_fn=_demix_fn(),
                            device="cpu")
    p._PAD_BUCKET_S = 10.0
    with lg.recording() as rec:
        res = p(waves[1])
    return rec, [s for s in rec.spans if s.name.startswith("demix.")], res


def test_demix_span_tree_and_counters(demix_recorded):
    rec, spans, res = demix_recorded
    assert res.diagnostics["route"] == "legacy"
    assert res.diagnostics["enhancer"] == "demix-dialog"
    assert _tree(spans, rec) == DEMIX_TREE
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    # 10 s padded to its 10 s bucket: 441,000 samples at 44.1 kHz, 4 s
    # chunks every 3 s: 3 chunks, one batch a net
    t44 = 441000
    assert [s.counts for s in by["demix.download"]] == [{"d2h_bytes": 10 * SR * 4}]
    assert [s.counts for s in by["demix.resample-in"]] == [{"samples": t44}]
    # the stereo wave up; the dialog stem at 16 kHz back under its own name
    assert [s.counts for s in by["demix.upload"]] == [{"h2d_bytes": 2 * t44 * 4}]
    assert [s.counts for s in by["demix.return"]] == [{"h2d_bytes": 10 * SR * 4}]
    assert [s.counts for s in by["demix.separate"]] == [
        {"nets": 2, "chunks": 3, "batches": 2}]
    assert [s.counts for s in by["demix.fetch"]] == [{"d2h_bytes": t44 * 4}]
    # per net and batch: encode, transformer, decode
    assert [s.name for s in spans if s.parent == by["demix.separate"][0].id] == [
        "demix.encode", "demix.transformer", "demix.decode"] * 2
    # 3 chunks of 176,400 samples: 1,379 spectral frames of one bin, and
    # 690 time steps, a chunk
    assert {tuple(sorted(s.counts.items())) for s in by["demix.transformer"]} == {
        (("spec_tokens", 3 * 1379), ("time_tokens", 3 * 690))}
    assert by["demix.ola"][0].counts is None and by["demix.resample-out"][0].counts is None
    (fid,) = {s.file for s in spans}
    assert fid is not None


def test_demix_waits_count_as_host_syncs(demix_recorded):
    """The copies each way are waits that no wait holds (a copy from
    pageable memory waits for the stream too): the rule of
    ``host_syncs_per_file`` counts each once a file."""
    from perfbench.metrics import _program_spans

    rec, spans, _ = demix_recorded
    ctx = SimpleNamespace(program_spans=rec)
    waits = _program_spans.outer_waits(ctx, rec.spans)
    copies = ["demix.download", "demix.upload", "demix.fetch", "demix.return"]
    assert [s.name for s in waits if s.name.startswith("demix.")] == copies
    assert all(s.wait == (s.name in copies) for s in spans)


def test_demix_host_reader_reads_the_resampling_alone(demix_recorded):
    """``demix_host_ms_per_min`` sums the two resampling spans' walls and
    none of the copies, which are waits on the separation."""
    from perfbench.metrics import demix_host_ms_per_min as reader

    rec, spans, _ = demix_recorded
    first = min(s.start_ns for s in rec.spans)
    last = max(s.end_ns for s in rec.spans)
    ctx = SimpleNamespace(program_spans=rec, t0=0.0, wall_minus_perf=first / 1e9 - 1.0,
                          window_s=(last - first) / 1e9 + 2.0, audio_s=30.0,
                          audio_min=lambda: 0.5)
    walls = [s.wall_ms for s in spans if s.name in ("demix.resample-in", "demix.resample-out")]
    assert len(walls) == 2
    assert reader.read(ctx) == pytest.approx(sum(walls) / 0.5, rel=1e-12)


def test_demix_without_a_recorder_makes_no_event_and_changes_no_bit(waves):
    fn = _demix_fn()
    y = torch.from_numpy(waves[1])
    assert lg.RECORDER is None
    with mock.patch.object(torch.cuda, "Event") as event:
        off = fn(y)
    assert event.call_count == 0
    with lg.recording() as rec:
        on = fn(y)
    assert torch.equal(on, off) and rec.spans

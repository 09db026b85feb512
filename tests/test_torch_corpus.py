"""The port's corpus worker (``pipelines/corpus.py``) against lone pipeline
calls and against the JAX package's corpus worker on the CPU.

Three 12 s draws, the second in white noise at 10 dB (the whole-file path
through GTCRN), at the config's defaults with the shipped conv VAD and
float32 encoder.  Bars: every file's final segments equal (edges within
1e-6 s, labels equal) to a lone call's, also when two files' ingests are
interleaved on one pipeline (the next file's ``stream_start`` dispatched
before the current file's ``stream_finish``, the order the worker runs),
and to the JAX corpus worker's; an error table entry per failing file, the
rest unaffected.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu.config as jc
import speech_diarization_tpu_torch.config as tc
from speech_diarization_tpu.pipelines.corpus import corpus_diarize as jcorpus
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu_torch.io.audio import write_wav
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.pipelines.corpus import CorpusReport, corpus_diarize
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout
from speech_diarization_tpu_torch.train.synthetic import make_conversation

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


@pytest.fixture(scope="module")
def draws():
    a, _ = make_conversation(np.random.default_rng(31), 12.0, n_speakers=2, sr=SR)
    b, _ = make_conversation_heldout(np.random.default_rng(32), 12.0, n_speakers=2,
                                     sr=SR, snr_db=10.0, noise_kind="white")
    c, _ = make_conversation(np.random.default_rng(33), 12.0, n_speakers=3, sr=SR)
    return [w.astype(np.float32) for w in (a, b, c)]


@pytest.fixture(scope="module")
def pipe():
    return DiarizationPipeline(
        tc.DiarizationConfig(),
        encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")


@pytest.fixture(scope="module")
def lone(pipe, draws):
    return [pipe(w) for w in draws]


def _same(t, j) -> None:
    assert len(t) == len(j) > 0
    np.testing.assert_allclose(t.starts, j.starts, atol=1e-6)
    np.testing.assert_allclose(t.ends, j.ends, atol=1e-6)
    np.testing.assert_array_equal(t.spks, j.spks)


def test_the_draws_take_both_routes(lone):
    assert [r.diagnostics["route"] for r in lone] == ["streamed", "legacy", "streamed"]


def test_interleaved_ingests_give_each_file_its_lone_segments(pipe, draws, lone):
    """Clean, then noisy (whole-file), then clean: each ``stream_start``
    goes out before the previous file's ``stream_finish``."""
    st = pipe.stream_start(draws[0])
    out = []
    for w in draws[1:]:
        nxt = pipe.stream_start(w)
        out.append(pipe.stream_finish(st))
        st = nxt
    out.append(pipe.stream_finish(st))
    for res, ref in zip(out, lone):
        assert res.diagnostics["route"] == ref.diagnostics["route"]
        _same(res.segments, ref.segments)


@pytest.mark.parametrize("kind", ["array", "pair"])
def test_corpus_files_equal_lone_calls(pipe, draws, lone, kind):
    sources = draws if kind == "array" else [(w, SR) for w in draws]
    report = corpus_diarize(sources, pipeline_factory=lambda: pipe,
                            keep_results=True)
    assert isinstance(report, CorpusReport) and report.errors == []
    assert sorted(f["index"] for f in report.files) == [0, 1, 2]
    assert report.audio_s == pytest.approx(36.0, abs=0.1)
    for f in report.files:
        assert f["source"] == f"array[{f['index']}]"
        assert f["segments"] == len(lone[f["index"]].segments)
        _same(f["result"].segments, lone[f["index"]].segments)
    assert report.summary()["files_ok"] == 3 and report.rtf > 0


def test_path_sources_are_prefetched_and_write_rttm(tmp_path, pipe, draws, lone):
    paths = []
    for i, w in enumerate(draws):
        paths.append(tmp_path / f"f{i}.wav")
        write_wav(paths[-1], w, SR)
    lone_paths = [pipe(str(p)) for p in paths]
    report = corpus_diarize([str(p) for p in paths], rttm_dir=tmp_path / "rttm",
                            pipeline_factory=lambda: pipe, keep_results=True)
    assert report.errors == []
    for f in report.files:
        _same(f["result"].segments, lone_paths[f["index"]].segments)
        assert (tmp_path / "rttm" / f"f{f['index']}.rttm").stat().st_size > 0


def test_a_failing_file_goes_to_the_error_table(tmp_path, pipe, draws, lone):
    sources = [draws[0], str(tmp_path / "missing.wav"), draws[2]]
    report = corpus_diarize(sources, pipeline_factory=lambda: pipe,
                            keep_results=True)
    assert [e["index"] for e in report.errors] == [1]
    assert report.errors[0]["source"].endswith("missing.wav")
    assert "FileNotFoundError" in report.errors[0]["error"]
    done = {f["index"]: f for f in report.files}
    assert sorted(done) == [0, 2]
    _same(done[2]["result"].segments, lone[2].segments)


def test_one_worker_per_device(draws, lone):
    """Two workers (two CPU "devices"), each with its own pipeline on the
    same modules, share the queue: every file once, lone segments."""
    report = corpus_diarize(
        draws, tc.DiarizationConfig(), devices=["cpu", "cpu"], keep_results=True,
        encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"))
    assert report.errors == [] and report.n_devices == 2
    assert sorted(f["index"] for f in report.files) == [0, 1, 2]
    for f in report.files:
        _same(f["result"].segments, lone[f["index"]].segments)


def test_fewer_files_than_cards_is_not_ported(draws):
    """Fewer files than devices, with an encoder to shard: the sharded
    route (ported; the name is kept from when it was refused).  One
    pipeline with the grid over a mesh of both devices, the JAX route's
    windowed grid (a sharded encoder is not streaming-trained): the file's
    segments equal a lone call of that pipeline's."""
    from speech_diarization_tpu_torch.parallel import make_mesh, make_sharded_encode_fn

    enc = load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz")
    vad = load_vad(WEIGHTS / "vad_conv_mc.npz")
    report = corpus_diarize(draws[:1], tc.DiarizationConfig(), devices=["cpu", "cpu"],
                            encode_model=enc, vad=vad, keep_results=True)
    assert report.errors == [] and report.n_devices == 2
    (entry,) = report.files
    assert entry["device"] == "sharded[2]" and entry["audio_s"] == 12.0
    lone = DiarizationPipeline(
        tc.DiarizationConfig(), device="cpu", vad=vad,
        encoder=make_sharded_encode_fn(enc, None, make_mesh(devices=["cpu", "cpu"])))
    res = lone(draws[0])
    assert res.diagnostics["grid"] == "windowed"
    _same(entry["result"].segments, res.segments)
    # without an encoder to shard, the files go to the workers as before
    report = corpus_diarize(draws[:1], tc.DiarizationConfig(), devices=["cpu", "cpu"],
                            encoder=enc, vad=vad)
    assert report.errors == [] and report.files[0]["device"] == "cpu"


def test_corpus_matches_the_jax_corpus_worker(draws, lone):
    """The JAX corpus worker on ``(wave, 16000)`` pairs (its whole-file path
    cannot read a bare array) at the same config, clustering on its numpy
    path, which the port runs."""
    jvad, jvp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jpipe = JPipe(jc.DiarizationConfig(),
                  encoder=jload_enc(WEIGHTS / "ecapa_robust_stream.npz"),
                  vad_probs_fn=jax.jit(partial(jvad.probs, jvp)))
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        report = jcorpus([(w, SR) for w in draws], jc.DiarizationConfig(),
                         pipeline_factory=lambda: jpipe, keep_results=True)
    finally:
        jspectral._device_capable = saved
    assert report.errors == []
    for f in report.files:
        ref = f["result"].segments
        out = lone[f["index"]].segments
        assert len(out) == len(ref) > 0
        # the whole-file path's GTCRN sums in another order: one 10 ms frame
        np.testing.assert_allclose(out.starts, ref.starts, atol=0.0101)
        np.testing.assert_allclose(out.ends, ref.ends, atol=0.0101)
        np.testing.assert_array_equal(out.spks, ref.spks)

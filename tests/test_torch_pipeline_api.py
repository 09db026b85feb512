"""The pipeline API around a call and the bucketed segment embeddings of the
PyTorch port against the JAX package.

Pieces and bars:

* ``embed_segments_bucketed`` at every bucket (0.5 to 16 s, a short
  segment padded with context, a segment cut at 16 s) on a seeded JAX ECAPA
  at small widths: rel < 1e-5 per embedding (float32); the partial groups'
  padding rows of the JAX package change no embedding, so the port encodes
  only the real rows.
* The pipeline with ``EmbedConfig(mode='bucketed')`` on the whole-file path
  (snippets cut from the preprocessed wave) and on the streamed path
  (snippets cut from the host array as read; reached by switching the mode
  between ``stream_start`` and ``stream_finish``, as the JAX package's
  streamed tail would take it): final segments equal (edges within 1e-6 s,
  labels equal), segment embeddings within 1e-4.
* ``collect_diagnostics``: the whole-file path; window starts, cluster
  labels and the three stage snapshots equal, segment embeddings within
  1e-4 (rel).
* ``prefetch`` then a call, ``load`` and the functional ``diarize()``: the
  same segments as the JAX package's; ``load``'s wave within 1e-6.

The JAX side clusters on its numpy spectral path (ROADMAP F2) and gets
``(wave, 16000)`` (ROADMAP F8).
"""
from __future__ import annotations

from dataclasses import replace
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu.config as jc
import speech_diarization_tpu_torch.config as tc
from speech_diarization_tpu.models.ecapa import EcapaModel as JEcapaModel
from speech_diarization_tpu.models.ecapa import EcapaTdnn as JEcapaTdnn
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe
from speech_diarization_tpu.pipelines.diarize import diarize as jdiarize
from speech_diarization_tpu.segment.embed import _bucket_len as jbucket_len
from speech_diarization_tpu.segment.embed import embed_segments_bucketed as jbucketed
from speech_diarization_tpu.train.recipes import _flatten
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu.types import SegmentArray as JSegs
from speech_diarization_tpu_torch.models.port import (
    load_speaker_encoder,
    load_vad,
    params_from_numpy,
)
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline, diarize
from speech_diarization_tpu_torch.segment.embed import _bucket_len, embed_segments_bucketed
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


@pytest.fixture(autouse=True)
def _jax_numpy_spectral():
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    yield
    jspectral._device_capable = saved


def _rel_rows(ref, out) -> float:
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float((np.linalg.norm(ref - out, axis=1) / np.linalg.norm(ref, axis=1)).max())


def _same_segments(t, j) -> None:
    assert len(t) == len(j) > 0
    np.testing.assert_allclose(t.starts, j.starts, atol=1e-6)
    np.testing.assert_allclose(t.ends, j.ends, atol=1e-6)
    np.testing.assert_array_equal(t.spks, j.spks)


@pytest.fixture(scope="module")
def conversation():
    w, _ = make_conversation(np.random.default_rng(9), 40.0, n_speakers=3, sr=SR)
    return w.astype(np.float32)


def test_bucket_lengths_match_jax():
    for n in (1, 7999, 8000, 8001, 64000, 64001, 255999, 256000, 900000):
        assert _bucket_len(n, 8000) == jbucket_len(n, 8000)


def test_embed_segments_bucketed_at_every_bucket(conversation):
    cfg = dict(n_mels=24, channels=32, emb_dim=16, scale=4, se_channels=8,
               att_channels=8)
    net = JEcapaTdnn(**cfg, dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(5))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    port = params_from_numpy(flat, {"net": {**cfg, "dilations": [2, 3, 4]}})
    # lengths (s) for the buckets 0.5, 1, 2, 4, 8, 16 s, one short segment
    # (context-padded) and one cut at 16 s; two of them share the 2 s bucket
    spans = [(0.1, 0.4), (1.0, 1.9), (3.0, 4.7), (5.0, 6.2), (7.0, 10.5),
             (11.0, 17.9), (18.0, 32.0), (2.0, 39.9), (33.0, 34.1)]
    s = np.array([a for a, _ in spans])
    e = np.array([b for _, b in spans])
    ref = jbucketed(jax.jit(partial(JEcapaModel(net).encode_batch, params)),
                    conversation, SR, JSegs(s, e), batch=4)
    out = embed_segments_bucketed(port.encode_batch, conversation, SR,
                                  SegmentArray(s, e), batch=4)
    assert out.shape == ref.shape == (len(spans), 16)
    assert _rel_rows(ref, out) < 1e-5
    # the same from a tensor (the whole-file path's device wave)
    again = embed_segments_bucketed(port.encode_batch, torch.from_numpy(conversation),
                                    SR, SegmentArray(s, e), batch=32)
    np.testing.assert_allclose(again, out, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    jm, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    return {"jenc": jload_enc(WEIGHTS / "ecapa_robust_stream.npz"),
            "jvad": jax.jit(partial(jm.probs, jp)),
            "tenc": load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
            "tvad": load_vad(WEIGHTS / "vad_conv_mc.npz")}


def _pipes(models, mode: str = "grid", overlap: bool = False):
    def cfg(mod):
        return mod.DiarizationConfig(
            cluster=mod.ClusterConfig(method="spectral", max_speakers=8),
            embed=mod.EmbedConfig(grid_backend="auto", mode=mode),
            overlap=mod.OverlapConfig(enabled=overlap),
            enhance=mod.EnhanceConfig(enabled=False))
    return (JPipe(cfg(jc), encoder=models["jenc"], vad_probs_fn=models["jvad"]),
            DiarizationPipeline(cfg(tc), encoder=models["tenc"], vad=models["tvad"],
                                device="cpu"))


def test_bucketed_on_the_whole_file_path_matches_jax(conversation, models):
    jp, tp = _pipes(models, mode="bucketed", overlap=True)
    wave = conversation[:25 * SR]
    assert not tp.streaming_capable()
    jres = jp((wave, SR), collect_diagnostics=True)
    tres = tp(wave, collect_diagnostics=True)
    assert tres.diagnostics["route"] == "legacy"
    _same_segments(tres.segments, jres.segments)
    assert _rel_rows(jres.diagnostics["segment_embeddings"],
                     tres.diagnostics["segment_embeddings"]) < 1e-4


def test_bucketed_on_the_streamed_path_matches_jax(conversation, models):
    """The streamed tail cuts its snippets from the host array as read, not
    from the preprocessed wave (ROADMAP F14)."""
    jp, tp = _pipes(models)
    wave = conversation[:25 * SR]
    jst, tst = jp.stream_start((wave, SR)), tp.stream_start(wave)
    assert "flat" in tst
    for pipe in (jp, tp):
        pipe.cfg = replace(pipe.cfg, embed=replace(pipe.cfg.embed, mode="bucketed"))
    jres, tres = jp.stream_finish(jst), tp.stream_finish(tst)
    assert tres.diagnostics["route"] == "streamed"
    _same_segments(tres.segments, jres.segments)


def test_collect_diagnostics_matches_jax(conversation, models):
    jp, tp = _pipes(models)
    wave = conversation[:20 * SR]
    jd = jp((wave, SR), collect_diagnostics=True).diagnostics
    tres = tp(wave, collect_diagnostics=True)
    td = tres.diagnostics
    assert td["route"] == "legacy"
    assert set(jd) <= set(td)
    np.testing.assert_allclose(td["window_starts_s"], jd["window_starts_s"], atol=1e-9)
    np.testing.assert_array_equal(td["labels"], jd["labels"])
    assert _rel_rows(jd["segment_embeddings"], td["segment_embeddings"]) < 1e-4
    for stage in ("stage_clustered", "stage_merged", "stage_reassigned"):
        _same_segments(td[stage], jd[stage])
    # without the flag: the streamed path, and no stage snapshots
    plain = tp(wave)
    assert plain.diagnostics["route"] == "streamed"
    assert "stage_clustered" not in plain.diagnostics


def test_prefetch_load_and_functional_diarize_match_jax(conversation, models):
    jp, tp = _pipes(models)
    wave = conversation[:15 * SR]
    pre = tp.prefetch(wave)
    assert pre[0].dtype == torch.int16 and pre[1:3] == (15 * SR, SR)
    jres = jp(jp.prefetch((wave, SR)))
    tres = tp(pre)
    assert tres.diagnostics["route"] == "legacy"
    _same_segments(tres.segments, jres.segments)
    jy, _ = jp.load((wave, SR))
    ty, sr = tp.load(wave)
    assert sr == SR and ty.shape == (15 * SR,)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
    jsegs = jdiarize((wave, SR), jp.cfg, encoder=models["jenc"],
                     vad_probs_fn=models["jvad"])
    tsegs = diarize((wave, SR), tp.cfg, encoder=models["tenc"], vad=models["tvad"],
                    device="cpu")
    assert [(s.start, s.end, s.spk) for s in tsegs] == pytest.approx(
        [(s.start, s.end, s.spk) for s in jsegs], abs=1e-6)

"""The PyTorch port's streamed diarizer as a whole, against the JAX
pipeline on the same file.

Setup: ``_PAD_BUCKET_S = 10.0`` on both pipeline instances (so a ~25 s
three-speaker file spans three chunks and the neighbour stitching runs),
overlap rescue, reassignment and the enhancement front-end off, the shipped
VAD and encoder in float32.  The JAX side clusters on its numpy path, the
one its main path ran on the TPU.  Bars: VAD probs atol 1e-4; grid cos >
0.9999; final segment boundaries within one 10 ms frame; labels equal up
to permutation; DER against the generator truth within 0.1 point.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu_torch as port
from speech_diarization_tpu.config import ClusterConfig as JClusterConfig
from speech_diarization_tpu.config import DiarizationConfig as JConfig
from speech_diarization_tpu.config import EnhanceConfig as JEnhanceConfig
from speech_diarization_tpu.config import OverlapConfig as JOverlapConfig
from speech_diarization_tpu.metrics.der import diarization_error_rate as jder
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipeline
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.io.audio import write_wav
from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _port_cfg(**kw):
    base = dict(cluster=port.ClusterConfig(method="spectral", max_speakers=8),
                overlap=port.OverlapConfig(enabled=False),
                enhance=port.EnhanceConfig(enabled=False))
    return port.DiarizationConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def conversation():
    w, truth = make_conversation(np.random.default_rng(3), 25.0, n_speakers=3, sr=SR)
    return w.astype(np.float32), truth


@pytest.fixture(scope="module")
def runs(conversation):
    w, _ = conversation
    jv, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jm, jpp = jload_enc(WEIGHTS / "ecapa_robust_stream.npz")
    jcfg = JConfig(cluster=JClusterConfig(method="spectral", max_speakers=8),
                   overlap=JOverlapConfig(enabled=False),
                   enhance=JEnhanceConfig(enabled=False))
    jpipe = JPipeline(jcfg, encoder=(jm, jpp),
                      vad_probs_fn=jax.jit(partial(jv.probs, jp)))
    jpipe._PAD_BUCKET_S = 10.0
    tpipe = DiarizationPipeline(
        _port_cfg(), encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")
    tpipe._PAD_BUCKET_S = 10.0
    jst = jpipe._streamed_start(w, SR)
    jout = jpipe._streamed_collect(jst)
    tout = tpipe._streamed_collect(tpipe._streamed_start(w, SR))
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        jres = jpipe(w)
    finally:
        jspectral._device_capable = saved
    return {"jout": jout, "tout": tout, "jres": jres, "tres": tpipe(w),
            "tpipe": tpipe}


def test_streamed_outputs_match(runs):
    jp, je, jg, js, jt = runs["jout"]
    tp, te, tg, ts, tt = runs["tout"]
    assert tp.shape == jp.shape == (25 * 100 + 1,)
    np.testing.assert_allclose(tp, jp, atol=1e-4)
    np.testing.assert_allclose(te, je, atol=1e-2)
    np.testing.assert_array_equal(ts, js)
    assert tt == jt
    assert tg.shape == jg.shape
    cos = (tg * jg).sum(1) / (np.linalg.norm(tg, axis=1) * np.linalg.norm(jg, axis=1))
    assert cos.min() > 0.9999, cos.min()


def test_final_segments_match(runs):
    a, b = runs["tres"].segments, runs["jres"].segments
    assert len(a) == len(b) > 0
    assert np.abs(a.starts - b.starts).max() <= 0.01
    assert np.abs(a.ends - b.ends).max() <= 0.01
    # labels equal up to a permutation
    pairs = set(zip(a.spks.tolist(), b.spks.tolist()))
    assert len(pairs) == len(set(a.spks.tolist())) == len(set(b.spks.tolist()))
    assert runs["tres"].num_speakers == runs["jres"].num_speakers == 3


def test_der_matches(runs, conversation):
    _, truth = conversation
    d_port = diarization_error_rate(SegmentArray(*truth), runs["tres"].segments).der
    d_jax = jder(JSegmentArray(*truth), JSegmentArray(
        runs["jres"].segments.starts, runs["jres"].segments.ends,
        runs["jres"].segments.spks)).der
    assert abs(d_port - d_jax) <= 0.001, (d_port, d_jax)
    assert d_port < 0.05


def test_repeat_call_is_identical(runs, conversation):
    w, _ = conversation
    again = runs["tpipe"](w).segments
    a = runs["tres"].segments
    np.testing.assert_array_equal(again.starts, a.starts)
    np.testing.assert_array_equal(again.spks, a.spks)


@pytest.mark.parametrize("kw,what", [
    (dict(overlap=port.OverlapConfig(enabled=True)), "overlap"),
    (dict(reseg=port.ResegConfig(enabled=True)), "reassignment"),
    (dict(cluster=port.ClusterConfig(method="ahc")), "ahc"),
])
def test_unported_stages_raise(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        DiarizationPipeline(_port_cfg(**kw), encoder=object(), vad=object(),
                            device="cpu")


def test_noisy_input_refused_while_enhancement_is_unported():
    """Enhancement on (the config default) engages on noisy input: the port
    refuses instead of diarizing without it."""
    pipe = DiarizationPipeline(
        _port_cfg(enhance=port.EnhanceConfig()),
        encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")
    noise = (0.1 * np.random.default_rng(0).standard_normal(SR * 3)).astype(np.float32)
    with pytest.raises(NotImplementedError, match="enhancement"):
        pipe(noise)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        DiarizationPipeline(_port_cfg(), encoder=object(), vad=object())


def test_cli_diarize_writes_all_formats(tmp_path, conversation):
    from speech_diarization_tpu_torch.cli import main

    w, _ = conversation
    wav = tmp_path / "conv.wav"
    write_wav(wav, w[:12 * SR], SR)
    rc = main(["diarize", str(wav), "--cpu", "--no-overlap", "--no-reseg",
               "--enhance", "off", "--out-dir", str(tmp_path / "out")])
    assert rc == 0
    for ext in ("rttm", "json", "srt", "csv"):
        assert (tmp_path / "out" / f"conv.{ext}").stat().st_size > 0


def test_cli_refuses_without_no_overlap(tmp_path, conversation):
    from speech_diarization_tpu_torch.cli import main

    w, _ = conversation
    wav = tmp_path / "conv.wav"
    write_wav(wav, w[:3 * SR], SR)
    with pytest.raises(NotImplementedError, match="overlap"):
        main(["diarize", str(wav), "--cpu", "--no-reseg", "--out-dir",
              str(tmp_path / "out")])

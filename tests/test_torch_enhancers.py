"""The whole default pipeline with the ZipEnhancer front-end
(``EnhanceConfig(backend='zipenhancer')``, shipped ``zipenhancer_mc.npz``)
against the JAX package's, on the 25 s held-out draw in white noise at
10 dB of ``test_torch_legacy.py``: the whole-file path through ZipEnhancer
on both sides, VAD probabilities within 1e-4, final segments and DER equal.

Both sides run batches of 8 windows (``EnhanceConfig(batch_size=8)``): the
rows are independent, so the result is that of the default 64, and the JAX
side stays small on the CPU.  The JAX ZipEnhancer costs about 2.4 s a
window here (40 windows of the file's 60 s pad), so this file holds this
run alone.
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
from speech_diarization_tpu.config import DiarizationConfig as JConfig
from speech_diarization_tpu.config import EnhanceConfig as JEnhanceConfig
from speech_diarization_tpu.metrics.der import diarization_error_rate as jder
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipeline
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


@pytest.fixture(scope="module")
def runs():
    w, truth = make_conversation_heldout(np.random.default_rng(11), 25.0,
                                         n_speakers=3, sr=SR, snr_db=10.0,
                                         noise_kind="white")
    w = w.astype(np.float32)
    jv, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jpipe = JPipeline(
        JConfig(enhance=JEnhanceConfig(backend="zipenhancer", batch_size=8)),
        encoder=jload_enc(WEIGHTS / "ecapa_robust_stream.npz"),
        vad_probs_fn=jax.jit(partial(jv.probs, jp)))
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False      # the JAX numpy clustering
    try:
        jres = jpipe((w, SR), collect_diagnostics=True)
    finally:
        jspectral._device_capable = saved
    tpipe = DiarizationPipeline(
        port.DiarizationConfig(enhance=port.EnhanceConfig(backend="zipenhancer",
                                                          batch_size=8)),
        encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")
    return {"truth": truth, "jres": jres, "tres": tpipe(w)}


def test_route_is_the_whole_file_path_through_zipenhancer(runs):
    d = runs["tres"].diagnostics
    assert d["route"] == "legacy" and d["enhancer"] == "zipenhancer"
    assert d["snr_db"] < 25.0 and "demix_requested" not in d


def test_vad_probs_match(runs):
    a = runs["tres"].diagnostics["vad_probs"]
    b = runs["jres"].diagnostics["vad_probs"]
    assert a.shape == b.shape == (25 * 100 + 1,)
    np.testing.assert_allclose(a, b, atol=1e-4)


def test_final_segments_match(runs):
    a, b = runs["tres"].segments, runs["jres"].segments
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.spks, b.spks)
    assert runs["tres"].num_speakers == runs["jres"].num_speakers


def test_der_matches(runs):
    truth, segs = runs["truth"], runs["tres"].segments
    d_port = diarization_error_rate(SegmentArray(*truth), segs).der
    b = runs["jres"].segments
    d_jax = jder(JSegmentArray(*truth), JSegmentArray(b.starts, b.ends, b.spks)).der
    assert d_port == pytest.approx(d_jax, abs=1e-9)
    assert d_port < 0.10

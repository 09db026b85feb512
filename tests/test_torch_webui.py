"""The port's web UI against the JAX package's (tests/test_webui.py's
inputs): the audio contract, the slider-wired diarize on the CPU, and
``build_ui``'s message without gradio (not installed here).

Bars: ``normalize_gradio_audio`` equal exactly; the segment tables of
``run_diarize_ui`` on ``make_tone_conversation(0)`` with the JAX test's
sliders equal exactly (both pipelines' segments are rounded to the
frame); the slider mapping gives the JAX UI's config, field for field.
"""
from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

from speech_diarization_tpu import config as jconfig
from speech_diarization_tpu import webui as jwebui
from speech_diarization_tpu_torch import config, webui
from speech_diarization_tpu_torch.train.synthetic import make_tone_conversation

torch.set_num_threads(4)
# tests/test_webui.py's sliders: vad on/off/min-speech/min-silence/pad,
# SCD threshold, clustering, max speakers, merge gap, max turn, min cosine,
# frame reassignment
SLIDERS = (0.5, 0.35, 250, 100, 30, 1.5, "ahc", 6, 0.5, 30.0, 0.8, True)


def test_normalize_int16_stereo():
    y = (np.random.default_rng(0).integers(-32768, 32767, size=(1000, 2))
         .astype(np.int16))
    out, sr = webui.normalize_gradio_audio((16000, y))
    ref, jsr = jwebui.normalize_gradio_audio((16000, y))
    assert sr == jsr == 16000 and out.dtype == np.float32 and out.ndim == 1
    np.testing.assert_array_equal(out, ref)
    f = np.random.default_rng(1).standard_normal(500).astype(np.float64)
    np.testing.assert_array_equal(webui.normalize_gradio_audio((8000, f))[0],
                                  jwebui.normalize_gradio_audio((8000, f))[0])


@pytest.mark.parametrize("denoise", [False, True])
def test_slider_config_is_the_jax_mapping(denoise):
    cfg = config.config_to_dict(webui._ui_config(*SLIDERS, denoise))
    ref = jconfig.config_to_dict(jconfig.DiarizationConfig(
        vad=jconfig.VadConfig(on_threshold=0.5, off_threshold=0.35,
                              min_speech_ms=250, min_silence_ms=100,
                              speech_pad_ms=30),
        scd=jconfig.ScdConfig(peak_z_threshold=1.5),
        cluster=jconfig.ClusterConfig(method="ahc", max_speakers=6),
        reseg=jconfig.ResegConfig(enabled=True),
        merge=jconfig.MergeConfig(max_gap_s=0.5, max_turn_s=30.0, min_cos=0.8),
        enhance=jconfig.EnhanceConfig(enabled=denoise, scope="auto")))
    assert {k: cfg[k] for k in ref} == ref


def test_run_diarize_ui_table_equals_jax():
    wave, _ = make_tone_conversation(0)
    audio = (16000, (wave * 32767).astype(np.int16))
    fig, table = webui.run_diarize_ui(audio, *SLIDERS, device="cpu")
    jfig, jtable = jwebui.run_diarize_ui(audio, *SLIDERS)
    assert fig is not None and jfig is not None
    assert len(table) >= 1
    assert table.to_dict("records") == jtable.to_dict("records")


def test_build_ui_without_gradio_raises_the_jax_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(RuntimeError) as ours:
        webui.build_ui()
    with pytest.raises(RuntimeError) as theirs:
        jwebui.build_ui()
    assert str(ours.value) == str(theirs.value)
    assert "gradio is not installed" in str(ours.value)

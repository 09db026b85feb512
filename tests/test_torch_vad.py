"""The PyTorch port's VAD and VAD post-processing against the JAX package.

Bars: probabilities within atol 1e-4 in float32 on ~5 s of generator speech
(same weights, same log-mel, summation order differs); segments identical
(host post-processing is exact); hysteresis, morphology and mask -> segment
conversion identical on random inputs.
"""
from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.config import VadConfig as JVadConfig
from speech_diarization_tpu.ops.hysteresis import hysteresis_binarize as jhyst
from speech_diarization_tpu.ops.morphology import morph_open_close as jmorph
from speech_diarization_tpu.segment.vad_post import apply_energy_veto as jveto
from speech_diarization_tpu.segment.vad_post import frame_energy_db_chunk as jenergy
from speech_diarization_tpu.segment.vad_post import vad_segments_from_probs as jsegs
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu_torch.config import VadConfig
from speech_diarization_tpu_torch.models.port import load_vad
from speech_diarization_tpu_torch.ops.hysteresis import hysteresis_binarize
from speech_diarization_tpu_torch.ops.morphology import morph_open_close
from speech_diarization_tpu_torch.segment.vad_post import (
    apply_energy_veto,
    frame_energy_db_chunk,
    vad_segments_from_probs,
)

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights" / "vad_conv_mc.npz"


@pytest.fixture(scope="module")
def vad_pair():
    return jload_vad(WEIGHTS), load_vad(WEIGHTS)


@pytest.fixture(scope="module")
def audio():
    w, _ = make_conversation(np.random.default_rng(11), 5.0, n_speakers=3, sr=SR)
    return w.astype(np.float32)


@pytest.fixture(scope="module")
def probs_pair(vad_pair, audio):
    (jm, jp), tm = vad_pair
    ref = np.asarray(jm.probs(jp, jnp.asarray(audio)))
    with torch.inference_mode():
        out = tm.probs(torch.from_numpy(audio)).numpy()
    return ref, out


def test_vad_probs_match_jax(probs_pair):
    ref, out = probs_pair
    assert out.shape == ref.shape == (5 * SR // 160 + 1,)
    np.testing.assert_allclose(out, ref, atol=1e-4)


def test_vad_segments_identical_with_energy_veto(probs_pair, audio):
    ref_p, out_p = probs_pair
    e_ref = np.asarray(jenergy(jnp.asarray(audio)[None], hop=160, n_extra=1))[0]
    e_out = frame_energy_db_chunk(torch.from_numpy(audio)[None], hop=160,
                                  n_extra=1)[0].numpy()
    np.testing.assert_allclose(e_out, e_ref, atol=1e-3)
    # identical inputs -> identical segments (host post is exact)
    ref = jsegs(ref_p, JVadConfig(), frame_energy_db=e_ref)
    out = vad_segments_from_probs(ref_p, VadConfig(), frame_energy_db=e_ref)
    np.testing.assert_array_equal(out.starts, ref.starts)
    np.testing.assert_array_equal(out.ends, ref.ends)
    assert len(out) > 0
    # the port's own probs and energy give the same segments here too
    mine = vad_segments_from_probs(out_p, VadConfig(), frame_energy_db=e_out)
    np.testing.assert_array_equal(mine.starts, ref.starts)
    np.testing.assert_array_equal(mine.ends, ref.ends)


@pytest.mark.parametrize("seed", range(4))
def test_energy_veto_identical(seed):
    g = np.random.default_rng(seed)
    p = g.uniform(0, 1, 3000).astype(np.float32)
    e = g.uniform(-90, -10, 3000).astype(np.float32)
    e[500:600] = -100.0
    np.testing.assert_array_equal(apply_energy_veto(p, e, VadConfig()),
                                  np.asarray(jveto(p, e, JVadConfig())))


@pytest.mark.parametrize("seed,on,off", [(0, 0.6, 0.4), (1, 0.5, 0.5),
                                         (2, 0.8, 0.2), (3, 0.6, 0.4)])
def test_hysteresis_identical(seed, on, off):
    g = np.random.default_rng(seed)
    # smooth random curve so runs of every kind occur
    p = np.convolve(g.uniform(0, 1, 5000), np.ones(9) / 9, mode="same")
    p = p.astype(np.float32)
    np.testing.assert_array_equal(hysteresis_binarize(p, on, off),
                                  np.asarray(jhyst(jnp.asarray(p), on, off)))


@pytest.mark.parametrize("open_ms,close_ms", [(80.0, 40.0), (30.0, 60.0),
                                              (0.0, 40.0), (80.0, 0.0)])
def test_morphology_identical(open_ms, close_ms):
    m = np.random.default_rng(int(open_ms + close_ms)).uniform(0, 1, 4000) > 0.4
    np.testing.assert_array_equal(
        morph_open_close(m, 10.0, open_ms, close_ms),
        np.asarray(jmorph(jnp.asarray(m), 10.0, open_ms, close_ms)))


@pytest.mark.parametrize("seed", range(3))
def test_vad_segments_identical_random_probs(seed):
    g = np.random.default_rng(100 + seed)
    p = np.convolve(g.uniform(0, 1, 6000), np.ones(25) / 25, mode="same")
    p = p.astype(np.float32)
    ref = jsegs(p, JVadConfig())
    out = vad_segments_from_probs(p, VadConfig())
    np.testing.assert_array_equal(out.starts, ref.starts)
    np.testing.assert_array_equal(out.ends, ref.ends)

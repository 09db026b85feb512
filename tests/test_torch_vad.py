"""The PyTorch port's VADs and VAD post-processing against the JAX package.

Bars: probabilities of the conv TCN and the GRU net (the shipped
``vad_synthetic.npz``) within atol 1e-4 in float32 on ~5 s of generator
speech (same weights, same log-mel, summation order differs); the energy
VAD within atol 1e-5 (float32 means in another order); segments identical
(host post-processing is exact); hysteresis, morphology and mask -> segment
conversion identical on random inputs.
"""
from __future__ import annotations

from functools import partial
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


GRU_WEIGHTS = WEIGHTS.with_name("vad_synthetic.npz")


def test_the_gru_vad_loads_by_the_jax_rule():
    """No ``__meta__`` (``vad_synthetic.npz``): the GRU net at its default
    widths; ``arch: conv``: the TCN."""
    from speech_diarization_tpu_torch.models.vad import VadConvNet, VadNet

    gru = load_vad(GRU_WEIGHTS)
    assert isinstance(gru.net, VadNet) and gru.net.stack == 8
    assert gru.net.gru.weight_ih_l0.shape == (3 * 96, 96 * 8)
    assert isinstance(load_vad(WEIGHTS).net, VadConvNet)


@pytest.mark.parametrize("batched", [False, True], ids=["T", "B,T"])
def test_gru_vad_probs_match_jax(audio, batched):
    jm, jp = jload_vad(GRU_WEIGHTS)
    tm = load_vad(GRU_WEIGHTS)
    y = np.stack([audio, audio[::-1].copy()]) if batched else audio
    ref = np.asarray(jm.probs(jp, jnp.asarray(y)))
    with torch.inference_mode():
        out = tm.probs(torch.from_numpy(y)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("win_ms", [25.0, 30.0])
@pytest.mark.parametrize("batched", [False, True], ids=["T", "B,T"])
def test_energy_vad_probs_match_jax(audio, win_ms, batched):
    from speech_diarization_tpu.models.vad import energy_vad_probs as jenergy_vad
    from speech_diarization_tpu_torch.models.vad import energy_vad_probs

    # a quiet second row: the noise floor is per row
    y = np.stack([audio, 0.05 * audio[::-1]]) if batched else audio
    ref = np.asarray(jenergy_vad(jnp.asarray(y), SR, win_ms, 10.0))
    out = energy_vad_probs(torch.from_numpy(y), SR, win_ms, 10.0).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_energy_vad_in_chunks_keeps_the_jax_frame_counts(audio):
    """The energy VAD has ``num_frames(T, win, hop)`` frames.  Stitched over
    15 s chunks as the whole-file path runs it: a one-chunk file keeps that
    count, as in the JAX package; a longer one has the centred count and
    matches the JAX stitch."""
    from speech_diarization_tpu.models.vad import energy_vad_probs as jenergy_vad
    from speech_diarization_tpu.pipelines.chunking import chunked_framewise as jchunked
    from speech_diarization_tpu_torch.models.vad import EnergyVad
    from speech_diarization_tpu_torch.pipelines.chunking import chunked_framewise

    vad = EnergyVad(SR, 30.0, 10.0)
    jfn = partial(jenergy_vad, sample_rate=SR, win_ms=30.0, hop_ms=10.0)
    for n in (15 * SR, 33 * SR + 777):
        y = np.tile(audio, -(-n // len(audio)))[:n]
        ref = jchunked(jfn, jnp.asarray(y), SR, frame_hop=160)
        out = chunked_framewise(vad.probs, torch.from_numpy(y), SR, 160).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5)
    assert out.shape == (n // 160 + 1,) and ref.shape[0] == n // 160 + 1


def test_a_bare_pipeline_uses_the_energy_vad_in_both_packages(audio):
    """With no VAD passed both pipelines score frames with the energy VAD
    at ``cfg.vad``'s window and hop (ROADMAP F13)."""
    from speech_diarization_tpu.config import DiarizationConfig as JCfg
    from speech_diarization_tpu.config import EnhanceConfig as JEnh
    from speech_diarization_tpu.models.vad import energy_vad_probs as jenergy_vad
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe
    from speech_diarization_tpu_torch.config import DiarizationConfig, EnhanceConfig
    from speech_diarization_tpu_torch.models.vad import EnergyVad
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline

    jpipe = JPipe(JCfg(enhance=JEnh(enabled=False)))
    tpipe = DiarizationPipeline(DiarizationConfig(enhance=EnhanceConfig(
        enabled=False)), device="cpu")
    assert isinstance(tpipe.vad, EnergyVad)
    cfg = tpipe.cfg.vad
    assert (tpipe.vad.win_ms, tpipe.vad.hop_ms) == (cfg.win_ms, cfg.hop_ms)
    y = audio[None]
    ref = np.asarray(jpipe.vad_probs_fn(jnp.asarray(y)))
    np.testing.assert_allclose(
        np.asarray(jenergy_vad(jnp.asarray(y), SR, cfg.win_ms, cfg.hop_ms)),
        ref, atol=1e-6)
    out = tpipe.vad.probs(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out[:, :ref.shape[1]], ref, atol=1e-5)


@pytest.mark.parametrize("argv,kind", [
    ([], "VadConvNet"), (["--vad-backend", "energy"], None),
    (["--vad-backend", "neural", "--vad-weights", str(GRU_WEIGHTS)], "VadNet"),
    (["--vad-backend", "auto", "--vad-weights", str(GRU_WEIGHTS)], "VadNet"),
], ids=["auto", "energy", "neural-gru", "auto-gru"])
def test_cli_vad_backends_resolve_as_the_jax_clis(argv, kind):
    """``auto`` / ``neural``: ``--vad-weights`` or the first shipped neural
    VAD (the conv TCN); ``energy``: the pipeline's energy VAD (no VAD
    passed), as ``speech_diarization_tpu/cli.py`` resolves them."""
    import argparse

    from speech_diarization_tpu_torch.cli import (
        _add_common_config_args, build_pipeline_kwargs,
    )

    p = argparse.ArgumentParser()
    _add_common_config_args(p)
    kwargs = build_pipeline_kwargs(p.parse_args(["--cpu", *argv]))
    if kind is None:
        assert "vad" not in kwargs
    else:
        assert type(kwargs["vad"].net).__name__ == kind

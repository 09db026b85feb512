"""The PyTorch port's streamed diarizer as a whole, against the JAX
pipeline on the same file.

Setup: ``_PAD_BUCKET_S = 10.0`` on both pipeline instances (so a ~25 s
three-speaker file spans three chunks and the neighbour stitching runs),
overlap rescue, reassignment and the enhancement front-end off, the shipped
VAD and encoder in float32.  The JAX side clusters on its numpy path, the
one its main path ran on the TPU.  Bars: VAD probs atol 1e-4; grid cos >
0.9999; final segment boundaries within one 10 ms frame; labels equal up
to permutation; DER against the generator truth within 0.1 point.

With the overlap rescue on (the shipped default), on a 25 s held-out draw
that has overlapped speech, same chunking: the detector's hard slot
decisions equal on at least 99.9 % of entries; overlap regions within
0.02 s; final segments and DER as above, once on the bench's surface
(reassignment off) and once on the CLI's (reassignment on, with and without
the HMM).  Streamed is compared against streamed.
"""
from __future__ import annotations

import dataclasses
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
from speech_diarization_tpu.config import ResegConfig as JResegConfig
from speech_diarization_tpu.metrics.der import diarization_error_rate as jder
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipeline
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.io.audio import write_wav
from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.segment.overlap import (
    detect_overlap_regions,
    make_seg_hard_fn,
)
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


# ------------------------------------------------- overlap rescue on -------
SURFACES = {"bench": dict(enabled=False), "cli": dict(enabled=True),
            "cli-hmm": dict(enabled=True, hmm=True)}


def _jax_on_numpy_spectral(fn):
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        return fn()
    finally:
        jspectral._device_capable = saved


def _pipelines(**overlap_kw):
    """(JAX pipeline, port pipeline) at the shipped overlap default, 10 s
    chunks, enhancement off, float32 encoder."""
    jv, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jm, jpp = jload_enc(WEIGHTS / "ecapa_robust_stream.npz")
    jpipe = JPipeline(
        JConfig(cluster=JClusterConfig(method="spectral", max_speakers=8),
                overlap=JOverlapConfig(**overlap_kw),
                enhance=JEnhanceConfig(enabled=False)),
        encoder=(jm, jpp), vad_probs_fn=jax.jit(partial(jv.probs, jp)))
    jpipe._PAD_BUCKET_S = 10.0
    tpipe = DiarizationPipeline(
        _port_cfg(overlap=port.OverlapConfig(**overlap_kw)),
        encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")
    tpipe._PAD_BUCKET_S = 10.0
    return jpipe, tpipe


@pytest.fixture(scope="module")
def overlapped():
    w, truth = make_conversation_heldout(np.random.default_rng(4000), 25.0,
                                         n_speakers=3, sr=SR, overlap_frac=0.3)
    return w.astype(np.float32), truth


@pytest.fixture(scope="module")
def ov_runs(overlapped):
    w, _ = overlapped
    jpipe, tpipe = _pipelines()
    jst = jpipe._streamed_start(w, SR)
    jpipe._streamed_collect(jst)
    tst = tpipe.stream_start(w)
    out = {"jst": jst, "tst": tst, "tpipe": tpipe}
    for name, reseg in SURFACES.items():
        jpipe.cfg = dataclasses.replace(jpipe.cfg, reseg=JResegConfig(**reseg))
        tpipe.cfg = dataclasses.replace(tpipe.cfg, reseg=port.ResegConfig(**reseg))
        out[name] = (_jax_on_numpy_spectral(lambda: jpipe(w)),
                     tpipe.stream_finish(tst))
    return out


def test_overlap_detector_arms_and_hard_decisions_match(ov_runs):
    jst, tst = ov_runs["jst"], ov_runs["tst"]
    assert jst["ov"] and tst["ov"]
    # 25 s -> ceil(20 / 2.5) + 1 = 9 windows of 501 frames and 3 slots
    assert tst["ov_acts"].shape == jst["ov_acts"].shape == (9, 501, 3)
    assert (tst["ov_acts"] == jst["ov_acts"]).mean() >= 0.999
    assert (tst["ov_acts"].sum(-1) >= 2).mean() > 0.02


def test_overlap_regions_match(ov_runs):
    from speech_diarization_tpu.segment.overlap import regions_from_hard_acts

    ref = regions_from_hard_acts(ov_runs["jst"]["ov_acts"], 25.0)
    out = ov_runs["bench"][1].diagnostics["overlap_regions"]
    assert len(out) == len(ref) > 0
    np.testing.assert_allclose(out.starts, ref.starts, atol=0.02)
    np.testing.assert_allclose(out.ends, ref.ends, atol=0.02)


@pytest.mark.parametrize("surface", list(SURFACES))
def test_final_segments_match_with_overlap_rescue(ov_runs, surface):
    jres, tres = ov_runs[surface]
    a, b = tres.segments, jres.segments
    assert len(a) == len(b) > 0
    assert np.abs(a.starts - b.starts).max() <= 0.01
    assert np.abs(a.ends - b.ends).max() <= 0.01
    pairs = set(zip(a.spks.tolist(), b.spks.tolist()))
    assert len(pairs) == len(set(a.spks.tolist())) == len(set(b.spks.tolist()))
    assert tres.num_speakers == jres.num_speakers == 3


@pytest.mark.parametrize("surface", list(SURFACES))
def test_der_matches_with_overlap_rescue(ov_runs, overlapped, surface):
    _, truth = overlapped
    jres, tres = ov_runs[surface]
    d_port = diarization_error_rate(SegmentArray(*truth), tres.segments).der
    d_jax = jder(JSegmentArray(*truth), JSegmentArray(
        jres.segments.starts, jres.segments.ends, jres.segments.spks)).der
    assert abs(d_port - d_jax) <= 0.001, (d_port, d_jax)
    assert d_port < 0.10


def test_rescue_emits_second_speaker_time(ov_runs):
    segs = ov_runs["cli"][1].segments
    ov = 0.0
    for i in range(len(segs)):
        for j in range(i + 1, len(segs)):
            if segs.spks[i] != segs.spks[j]:
                ov += max(0.0, min(segs.ends[i], segs.ends[j])
                          - max(segs.starts[i], segs.starts[j]))
    assert ov > 0.5, f"no second-speaker time emitted ({ov:.2f}s)"


def test_fused_regions_match_standalone_detect(ov_runs, overlapped):
    """The per-chunk program's detector against the port's standalone
    ``detect_overlap_regions`` on the same audio: the int16 ingest may flip
    one borderline 10 ms frame at a region edge."""
    w, _ = overlapped
    fused = ov_runs["bench"][1].diagnostics["overlap_regions"]
    ref = detect_overlap_regions(
        w, SR, make_seg_hard_fn(ov_runs["tpipe"]._overlap_seg()), device="cpu")
    assert len(fused) == len(ref)
    np.testing.assert_allclose(fused.starts, ref.starts, atol=0.02)
    np.testing.assert_allclose(fused.ends, ref.ends, atol=0.02)


def test_standalone_detect_runs_when_the_window_grid_cannot_arm(overlapped):
    """A 3 s window hop does not divide the 10 s chunk: the detector stays
    out of the chunk program and the rescue scores the whole file, in both
    packages."""
    w, _ = overlapped
    w = w[:15 * SR]
    jpipe, tpipe = _pipelines(chunk_hop_s=3.0)
    tst = tpipe.stream_start(w)
    assert tst["ov"] is False and jpipe._streamed_start(w, SR)["ov"] is False
    tres = tpipe.stream_finish(tst)
    jres = _jax_on_numpy_spectral(lambda: jpipe(w))
    assert "overlap_regions" not in tres.diagnostics
    a, b = tres.segments, jres.segments
    assert len(a) == len(b) > 0
    assert np.abs(a.starts - b.starts).max() <= 0.02
    assert np.abs(a.ends - b.ends).max() <= 0.02


def test_noise_veto_disarms_the_detector_and_programs_are_keyed_by_it(
        ov_runs, overlapped):
    """Below ``overlap.min_snr_db`` the detector neither arms nor runs
    standalone; the program with it and the program without it sit side by
    side in the cache."""
    w, _ = overlapped
    rng = np.random.default_rng(1)
    noisy = (w[:12 * SR] + 0.02 * rng.standard_normal(12 * SR)).astype(np.float32)
    tpipe = ov_runs["tpipe"]
    tst = tpipe.stream_start(noisy)
    assert tst["snr_db"] < 25.0 and tst["ov"] is False
    res = tpipe.stream_finish(tst)
    assert "overlap_regions" not in res.diagnostics
    assert {k[-1] for k in tpipe._programs} == {True, False}


@pytest.mark.parametrize("kw,what", [
    (dict(embed=port.EmbedConfig(mode="bucketed")), "bucketed"),
])
def test_unported_stages_raise(kw, what):
    """The bucketed embeddings, once refused here, build and take the
    whole-file path (their runs: ``test_torch_pipeline_api.py``); an unknown
    embedding mode is refused."""
    pipe = DiarizationPipeline(_port_cfg(**kw), encoder=load_speaker_encoder(
        WEIGHTS / "ecapa_robust_stream.npz"), vad=load_vad(WEIGHTS / "vad_conv_mc.npz"),
        device="cpu")
    assert pipe.cfg.embed.mode == what and not pipe.streaming_capable()
    with pytest.raises(ValueError, match="unknown embed mode"):
        DiarizationPipeline(_port_cfg(embed=port.EmbedConfig(mode="segments")),
                            encoder=object(), vad=object(), device="cpu")


@pytest.mark.parametrize("backend,weights", [
    ("zipenhancer", None), ("demix-dialog", None), ("zipenhancer-ref", "x.npz")])
def test_unported_enhancement_backends_raise(backend, weights, tmp_path):
    """Every enhancement backend is ported now, the published ZipEnhancer
    graph too (built here from an ``.npz`` of its seed-0 draw): the pipeline
    builds each enhancer, which keeps a waveform's length (the whole-file
    runs: test_torch_enhancers.py, test_torch_demix.py,
    test_torch_zipenhancer_ref.py)."""
    if weights is not None:
        from speech_diarization_tpu_torch.models import ZipEnhancerRef
        from speech_diarization_tpu_torch.models.registry import seeded_state_dict

        weights = tmp_path / weights
        np.savez(weights, **seeded_state_dict(ZipEnhancerRef().manifest(), 0))
    cfg = _port_cfg(enhance=port.EnhanceConfig(backend=backend, weights=weights))
    pipe = DiarizationPipeline(
        cfg, encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")
    y = torch.from_numpy(np.random.default_rng(0).standard_normal(SR)
                         .astype(np.float32) * 0.1)
    out = pipe.enhance_fn(y)
    assert out.shape == y.shape and torch.isfinite(out).all()


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        DiarizationPipeline(_port_cfg(), encoder=object(), vad=object())


@pytest.mark.parametrize("flags", [
    ["--no-overlap", "--no-reseg"],
    [],                                   # the CLI's defaults
], ids=["no-overlap-no-reseg", "defaults"])
def test_cli_diarize_writes_all_formats(tmp_path, conversation, flags):
    from speech_diarization_tpu_torch.cli import main

    w, _ = conversation
    wav = tmp_path / "conv.wav"
    write_wav(wav, w[:12 * SR], SR)
    rc = main(["diarize", str(wav), "--cpu", *flags, "--enhance", "off",
               "--out-dir", str(tmp_path / "out")])
    assert rc == 0
    for ext in ("rttm", "json", "srt", "csv"):
        assert (tmp_path / "out" / f"conv.{ext}").stat().st_size > 0


def test_cli_defaults_are_the_jax_clis():
    """Overlap rescue at the config default (on), reassignment on, HMM off;
    the flags switch them."""
    import argparse

    from speech_diarization_tpu_torch.cli import _add_common_config_args, build_config

    def cfg(*argv):
        p = argparse.ArgumentParser()
        _add_common_config_args(p)
        return build_config(p.parse_args(list(argv)))

    c = cfg()
    assert c.overlap.enabled and c.overlap.weights is None
    assert c.reseg.enabled and not c.reseg.hmm
    c = cfg("--no-overlap", "--no-reseg")
    assert not c.overlap.enabled and not c.reseg.enabled
    c = cfg("--hmm", "--overlap-weights", "x.npz")
    assert c.reseg.hmm and c.overlap.weights == "x.npz"


@pytest.mark.parametrize("argv", [
    [], ["--enhance", "off"], ["--enhance", "gtcrn", "--enhance-scope", "vad"],
    ["--enhance-scope", "full", "--enhance-weights", "x.npz"],
    ["--enhance", "zipenhancer"], ["--enhance", "demix-dialog"],
], ids=["defaults", "off", "vad", "full-weights", "zipenhancer", "demix"])
def test_cli_enhancement_flags_are_the_jax_clis(argv):
    import argparse

    from speech_diarization_tpu.cli import _add_common_config_args as jadd
    from speech_diarization_tpu.cli import build_config as jbuild
    from speech_diarization_tpu_torch.cli import _add_common_config_args, build_config

    def cfg(add, build):
        p = argparse.ArgumentParser()
        add(p)
        return build(p.parse_args(argv)).enhance

    a, b = cfg(_add_common_config_args, build_config), cfg(jadd, jbuild)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_pipeline_at_the_config_defaults_runs_on_the_cpu(conversation):
    """``DiarizationConfig()`` but for the enhancement front-end: overlap
    rescue on, spectral clustering, one 60 s chunk."""
    w, _ = conversation
    pipe = DiarizationPipeline(
        port.DiarizationConfig(enhance=port.EnhanceConfig(enabled=False)),
        device="cpu")
    res = pipe(w[:12 * SR])
    assert len(res.segments) > 0
    assert res.diagnostics["overlap_hard"].shape == (4, 501, 3)

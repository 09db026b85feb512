"""The port's whole-file ("legacy") path, which noisy input takes through
the GTCRN denoiser, against the JAX package on the same inputs.

Pieces: ``chunked_framewise`` (VAD probabilities over 40 s, three 15 s
chunks: atol 1e-4; frame energy stitched at several lengths: atol 1e-3 dB),
``embed_windows_streaming`` with 64 windows a chunk (three chunks, cos >
0.9999), whole-file ``loudness_normalize`` (atol 1e-5), and the SNR /
noise-floor probe (1e-3 dB, 1e-4).

The whole pipeline at ``DiarizationConfig()`` (enhancement on, scope
``auto``, GTCRN on ``gtcrn_mc.npz``, overlap rescue on, shipped VAD and
float32 encoder) on 25 s held-out draws in white noise at 10 dB and babble
at 15 dB: the probe within 1e-3 dB / 1e-4, the same route (whole-file,
GTCRN; the babble floor asks for the demix route, which falls back to GTCRN
for lack of a separation-grade demixer), VAD probabilities within 1e-4,
grid cos > 0.9999, final segments within one 10 ms frame, labels equal up
to permutation, DER within 0.1 point.  The JAX side gets ``(wave, 16000)``:
its whole-file path cannot read a bare array (ROADMAP F8); the port takes
either.  Then the forced scopes ``full`` and ``vad`` and the CLI's surface
(frame reassignment on).  The JAX side clusters on its numpy path.
"""
from __future__ import annotations

import dataclasses
import logging
import types
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu_torch as port
import speech_diarization_tpu_torch.pipelines.enhance as port_enhance
from speech_diarization_tpu.config import DiarizationConfig as JConfig
from speech_diarization_tpu.config import ResegConfig as JResegConfig
from speech_diarization_tpu.dsp.loudness import loudness_normalize as jloudness_normalize
from speech_diarization_tpu.metrics.der import diarization_error_rate as jder
from speech_diarization_tpu.pipelines.chunking import chunked_framewise as jchunked
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipeline
from speech_diarization_tpu.segment import embed_windows_streaming as jembed_streaming
from speech_diarization_tpu.segment import frame_energy_db_chunk as jframe_energy
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.dsp.loudness import loudness_normalize
from speech_diarization_tpu_torch.io.audio import write_wav
from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.pipelines.chunking import (
    chunked_framewise,
    stitch_index,
)
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.segment import (
    embed_windows_streaming,
    frame_energy_db_chunk,
)
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
# (seed, noise kind, SNR dB) of the 25 s held-out draws
DRAWS = {"white10": (11, "white", 10.0), "babble15": (12, "babble", 15.0)}


def _draw(name: str, seconds: float = 25.0):
    seed, kind, snr = DRAWS[name]
    w, truth = make_conversation_heldout(np.random.default_rng(seed), seconds,
                                         n_speakers=3, sr=SR, snr_db=snr,
                                         noise_kind=kind)
    return w.astype(np.float32), truth


def _jax_numpy_spectral(fn):
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        return fn()
    finally:
        jspectral._device_capable = saved


def _der(truth, segs) -> float:
    return diarization_error_rate(SegmentArray(*truth), SegmentArray(
        segs.starts, segs.ends, segs.spks)).der


def _same_segments(a, b, tol: float = 0.01) -> None:
    assert len(a) == len(b) > 0
    assert np.abs(a.starts - b.starts).max() <= tol
    assert np.abs(a.ends - b.ends).max() <= tol
    pairs = set(zip(a.spks.tolist(), b.spks.tolist()))
    assert len(pairs) == len(set(a.spks.tolist())) == len(set(b.spks.tolist()))


@pytest.fixture(scope="module")
def models():
    jv, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jm, jpp = jload_enc(WEIGHTS / "ecapa_robust_stream.npz")
    return {"jvad": (jv, jp), "jenc": (jm, jpp),
            "vad": load_vad(WEIGHTS / "vad_conv_mc.npz"),
            "enc": load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz")}


@pytest.fixture(scope="module")
def pipes(models):
    """The JAX and the port pipeline at ``DiarizationConfig()``; tests that
    change the config put it back."""
    jv, jp = models["jvad"]
    jpipe = JPipeline(JConfig(), encoder=models["jenc"],
                      vad_probs_fn=jax.jit(partial(jv.probs, jp)))
    tpipe = DiarizationPipeline(port.DiarizationConfig(), encoder=models["enc"],
                                vad=models["vad"], device="cpu")
    return jpipe, tpipe


# ------------------------------------------------------------- pieces ----
@pytest.fixture(scope="module")
def forty_s():
    return _draw("white10", 40.0)[0]


def test_chunked_vad_probs_match_on_three_chunks(models, forty_s):
    jv, jp = models["jvad"]
    ref = jchunked(jax.jit(partial(jv.probs, jp)), forty_s, SR, frame_hop=160)
    with torch.inference_mode():
        out = chunked_framewise(models["vad"].probs, torch.from_numpy(forty_s),
                                SR, frame_hop=160).numpy()
    assert out.shape == ref.shape == (40 * 100 + 1,)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("seconds", [10.0, 15.0, 15.0 + 1 / SR, 29.0, 40.0, 211.3])
def test_chunked_frame_energy_matches(seconds):
    """One chunk, exactly one, one sample more, two, three and fifteen
    chunks: every frame comes from the chunk the JAX stitch takes it from."""
    y = (0.3 * np.random.default_rng(1).standard_normal(int(seconds * SR))
         ).astype(np.float32)
    ref = jchunked(jax.jit(partial(jframe_energy, hop=160, n_extra=1)), y, SR,
                   frame_hop=160)
    out = chunked_framewise(lambda r: frame_energy_db_chunk(r, hop=160, n_extra=1),
                            torch.from_numpy(y), SR, frame_hop=160).numpy()
    assert out.shape == ref.shape == (len(y) // 160 + 1,)
    np.testing.assert_allclose(out, ref, atol=1e-3)


@pytest.mark.parametrize("n_chunks,fpc,hop_f,n_total", [(3, 1501, 1400, 4001),
                                                        (2, 11, 8, 19),
                                                        (5, 101, 60, 341)])
def test_stitch_index_covers_every_frame_once(n_chunks, fpc, hop_f, n_total):
    idx = stitch_index(n_chunks, fpc, hop_f, n_total, 25)
    assert len(np.unique(idx)) == n_total
    # frames come in order and each from a chunk that holds them
    k, local = idx // fpc, idx % fpc
    assert (np.diff(k) >= 0).all()
    np.testing.assert_array_equal(k * hop_f + local, np.arange(n_total))


def test_embed_windows_streaming_stitches_chunks(models, forty_s):
    """20 s at 64 windows a chunk: 181 windows in three chunks."""
    y = forty_s[:20 * SR]
    jm, jpp = models["jenc"]
    ref = jembed_streaming(jm, jpp, jnp.asarray(y), SR, 2.0, 0.1,
                           windows_per_chunk=64)
    with torch.inference_mode():
        out = embed_windows_streaming(models["enc"], torch.from_numpy(y), SR,
                                      2.0, 0.1, windows_per_chunk=64).numpy()
    assert out.shape == ref.shape == (181, 128)
    cos = (out * ref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
    assert cos.min() > 0.9999, cos.min()


@pytest.mark.parametrize("margin_s", [2.0, 1.25])
def test_embed_windows_streaming_takes_margin_s(models, forty_s, margin_s):
    """A shorter context margin (1.25 s rounds up to 13 hops of 0.1 s), the
    same 20 s and 64 windows a chunk: the JAX grid at the same margin."""
    y = forty_s[:20 * SR]
    jm, jpp = models["jenc"]
    ref = jembed_streaming(jm, jpp, jnp.asarray(y), SR, 2.0, 0.1,
                           windows_per_chunk=64, margin_s=margin_s)
    with torch.inference_mode():
        out = embed_windows_streaming(models["enc"], torch.from_numpy(y), SR,
                                      2.0, 0.1, windows_per_chunk=64,
                                      margin_s=margin_s).numpy()
    assert out.shape == ref.shape == (181, 128)
    cos = (out * ref).sum(1) / np.linalg.norm(out, axis=1) / np.linalg.norm(ref, axis=1)
    assert cos.min() > 0.9999, cos.min()


def test_whole_file_loudness_matches(forty_s):
    y = np.pad(forty_s[:25 * SR], (0, 35 * SR))
    out = loudness_normalize(torch.from_numpy(y), SR).numpy()
    np.testing.assert_allclose(out, np.asarray(jloudness_normalize(
        jnp.asarray(y), SR)), atol=1e-5)


def _probe_cases():
    rng = np.random.default_rng(2)
    speech = _draw("babble15", 12.0)[0]
    gaps = speech.copy()
    gaps[3 * SR:5 * SR] = 0.0                    # digital silence
    return {"white10": _draw("white10", 12.0)[0], "babble15": speech,
            "gated": gaps, "noise": 0.1 * rng.standard_normal(12 * SR),
            "silence": np.zeros(12 * SR), "short": rng.standard_normal(700)}


@pytest.mark.parametrize("case", ["white10", "babble15", "gated", "noise",
                                  "silence", "short"])
def test_snr_probe_matches(case):
    y = np.asarray(_probe_cases()[case], np.float32)
    t = len(y)
    q, scale = DiarizationPipeline._quantize_host(y, max(60 * SR, t))
    jself = types.SimpleNamespace(_SNR_FRAME=800)
    snr_j = JPipeline._estimate_snr_db(jself, jnp.asarray(q), t)
    # the port's whole-file path reuses the streamed probe on the
    # dequantized samples and adds the floor's HF fraction on the int16 ones
    tself = types.SimpleNamespace(_SNR_FRAME=800)
    snr = DiarizationPipeline._host_snr_db(
        tself, q[:t].astype(np.float32) * (scale / 32767.0))
    hf = DiarizationPipeline._floor_hf_frac(tself, q, t)
    if np.isinf(snr_j):
        assert np.isinf(snr)
    else:
        assert abs(snr - snr_j) <= 1e-3, (snr, snr_j)
    assert abs(hf - jself._last_floor_hf_frac) <= 1e-4


# ---------------------------------------------------- the whole path ----
@pytest.fixture(scope="module")
def runs(pipes):
    jpipe, tpipe = pipes
    out = {}
    for name in DRAWS:
        w, truth = _draw(name)
        # the JAX default path leaves the streamed ingest for this file...
        j_streamed = jpipe._streamed_start(w, SR)
        # ...for the whole-file path, which collects its diagnostics
        jres = _jax_numpy_spectral(lambda: jpipe((w, SR), collect_diagnostics=True))
        out[name] = {"w": w, "truth": truth, "j_streamed": j_streamed,
                     "jres": jres, "jsnr": jpipe._last_snr_db,
                     "jhf": jpipe._last_floor_hf_frac, "tres": tpipe(w)}
    return out


@pytest.mark.parametrize("name", list(DRAWS))
def test_probe_matches_on_the_pipeline(runs, name):
    r = runs[name]
    d = r["tres"].diagnostics
    assert d["snr_db"] < 25.0
    assert abs(d["snr_db"] - r["jsnr"]) <= 1e-3
    assert abs(d["floor_hf_frac"] - r["jhf"]) <= 1e-4


@pytest.mark.parametrize("name", list(DRAWS))
def test_route_matches(runs, name):
    r = runs[name]
    d = r["tres"].diagnostics
    assert r["j_streamed"] is None
    assert d["route"] == "legacy" and d["enhancer"] == "gtcrn"
    # babble has a speech-shaped floor: the demix route is asked for and,
    # with no separation-grade demixer shipped, GTCRN is kept
    babble = name.startswith("babble")
    assert (r["jhf"] < 0.25) == babble
    assert d.get("demix_requested", False) == babble


@pytest.mark.parametrize("name", list(DRAWS))
def test_vad_probs_match(runs, name):
    r = runs[name]
    a = r["tres"].diagnostics["vad_probs"]
    b = r["jres"].diagnostics["vad_probs"]
    assert a.shape == b.shape == (25 * 100 + 1,)
    np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("name", list(DRAWS))
def test_grid_matches(runs, name):
    r = runs[name]
    a = r["tres"].diagnostics["window_embeddings"]
    b = r["jres"].diagnostics["window_embeddings"]
    assert a.shape == b.shape == (231, 128)
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    assert cos.min() > 0.9999, cos.min()


@pytest.mark.parametrize("name", list(DRAWS))
def test_final_segments_match(runs, name):
    r = runs[name]
    _same_segments(r["tres"].segments, r["jres"].segments)
    assert r["tres"].num_speakers == r["jres"].num_speakers


@pytest.mark.parametrize("name", list(DRAWS))
def test_der_matches(runs, name):
    r = runs[name]
    d_port = _der(r["truth"], r["tres"].segments)
    d_jax = jder(JSegmentArray(*r["truth"]), JSegmentArray(
        r["jres"].segments.starts, r["jres"].segments.ends,
        r["jres"].segments.spks)).der
    assert abs(d_port - d_jax) <= 0.001, (d_port, d_jax)
    assert d_port < 0.10


def test_array_and_pair_sources_agree(runs, pipes):
    """A bare array takes the whole-file path in the port (the JAX path
    cannot read one there, ROADMAP F8), and gives what ``(wave, sr)``
    gives."""
    _, tpipe = pipes
    w = runs["white10"]["w"]
    st = tpipe.stream_start(w)
    assert st["legacy_source"].shape == w.shape and "flat" not in st
    a, b = tpipe((w, SR)).segments, runs["white10"]["tres"].segments
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.spks, b.spks)


def test_the_whole_file_path_goes_on_from_the_streamed_start(runs, pipes):
    """The probe's route hands the quantized file, its upload and the SNR
    on; the whole-file path started afresh (quantize and probe again)
    gives the same result."""
    _, tpipe = pipes
    w = runs["white10"]["w"]
    st = tpipe.stream_start(w)
    q, q_dev, scale, snr = st["quantized"]
    assert q.shape == q_dev.shape == (60 * SR,)
    np.testing.assert_array_equal(q_dev.numpy(), q)
    assert snr == runs["white10"]["tres"].diagnostics["snr_db"]
    fresh = tpipe._legacy_call(w)
    handed = tpipe.stream_finish(st)
    for res in (fresh, handed):
        assert res.diagnostics["snr_db"] == snr
        assert res.diagnostics["floor_hf_frac"] == runs["white10"]["tres"].diagnostics["floor_hf_frac"]
        np.testing.assert_array_equal(res.segments.starts,
                                      runs["white10"]["tres"].segments.starts)
        np.testing.assert_array_equal(res.segments.spks,
                                      runs["white10"]["tres"].segments.spks)


@pytest.mark.parametrize("scope", ["full", "vad"])
def test_a_forced_scope_leaves_the_streamed_start_before_any_work(pipes, runs,
                                                                  scope):
    _, tpipe = pipes
    tcfg = tpipe.cfg
    try:
        tpipe.cfg = dataclasses.replace(
            tcfg, enhance=dataclasses.replace(tcfg.enhance, scope=scope))
        # no quantized file, no uploads, no probe: the waveform, its
        # length and the file's id only
        assert set(tpipe.stream_start(runs["white10"]["w"])) == {
            "legacy_source", "t", "sr", "file_id"}
        assert tpipe._last_snr_db is None
    finally:
        tpipe.cfg = tcfg


@pytest.fixture(scope="module")
def scope_runs(pipes, runs):
    jpipe, tpipe = pipes
    jcfg, tcfg = jpipe.cfg, tpipe.cfg
    w = runs["white10"]["w"]
    out = {}
    try:
        for scope in ("full", "vad"):
            jpipe.cfg = dataclasses.replace(
                jcfg, enhance=dataclasses.replace(jcfg.enhance, scope=scope))
            tpipe.cfg = dataclasses.replace(
                tcfg, enhance=dataclasses.replace(tcfg.enhance, scope=scope))
            out[scope] = (_jax_numpy_spectral(lambda: jpipe((w, SR))), tpipe(w))
    finally:
        jpipe.cfg, tpipe.cfg = jcfg, tcfg
    return out


@pytest.mark.parametrize("scope", ["full", "vad"])
def test_forced_scope_segments_match(scope_runs, scope):
    jres, tres = scope_runs[scope]
    assert tres.diagnostics["route"] == "legacy"
    assert tres.diagnostics["enhancer"] == "gtcrn"
    assert "snr_db" not in tres.diagnostics       # no probe under a forced scope
    _same_segments(tres.segments, jres.segments)


@pytest.mark.parametrize("scope", ["full", "vad"])
def test_forced_scope_der_matches(scope_runs, runs, scope):
    jres, tres = scope_runs[scope]
    truth = runs["white10"]["truth"]
    assert abs(_der(truth, tres.segments) - _der(truth, jres.segments)) <= 0.001


@pytest.fixture(scope="module")
def cli_runs(pipes, runs, tmp_path_factory):
    """The CLI's surface (frame reassignment on) on the babble draw read
    from a WAV file by both packages."""
    from speech_diarization_tpu.cli import _add_common_config_args as jadd
    from speech_diarization_tpu.cli import build_config as jbuild
    from speech_diarization_tpu_torch.cli import (
        _add_common_config_args, build_config, build_pipeline_kwargs,
    )
    import argparse

    wav = tmp_path_factory.mktemp("cli") / "babble15.wav"
    write_wav(wav, runs["babble15"]["w"], SR)

    def parse(add, argv):
        p = argparse.ArgumentParser()
        add(p)
        return p.parse_args(argv)

    jpipe, _ = pipes
    jcfg = jpipe.cfg
    try:
        jpipe.cfg = jbuild(parse(jadd, []))
        assert jpipe.cfg.reseg.enabled
        jres = _jax_numpy_spectral(lambda: jpipe(str(wav)))
    finally:
        jpipe.cfg = jcfg
    args = parse(_add_common_config_args, ["--cpu"])
    tpipe = DiarizationPipeline(build_config(args), **build_pipeline_kwargs(args))
    return wav, jres, tpipe(str(wav))


def test_cli_surface_segments_match(cli_runs):
    _, jres, tres = cli_runs
    assert tres.diagnostics["route"] == "legacy"
    _same_segments(tres.segments, jres.segments)


def test_cli_surface_der_matches(cli_runs, runs):
    _, jres, tres = cli_runs
    truth = runs["babble15"]["truth"]
    assert abs(_der(truth, tres.segments) - _der(truth, jres.segments)) <= 0.001


def test_cli_diarizes_a_noisy_file_at_its_defaults(cli_runs, tmp_path):
    from speech_diarization_tpu_torch.cli import main

    wav = cli_runs[0]
    assert main(["diarize", str(wav), "--cpu", "--out-dir", str(tmp_path)]) == 0
    for ext in ("rttm", "json", "srt", "csv"):
        assert (tmp_path / f"babble15.{ext}").stat().st_size > 0


# ----------------------------------------------------------- repairs -----
def test_no_shipped_enhancer_drops_the_stage(models, runs, monkeypatch):
    """Enhancement on but no trained weights: the stage is dropped with a
    warning (as in the JAX package) and a noisy file streams."""
    monkeypatch.setattr(port_enhance, "default_weights_path", lambda backend: None)
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("sdtpu.diarize")
    logger.addHandler(handler)
    try:
        pipe = DiarizationPipeline(port.DiarizationConfig(), encoder=models["enc"],
                                   vad=models["vad"], device="cpu")
    finally:
        logger.removeHandler(handler)
    assert pipe.enhance_fn is None
    assert any("stage disabled" in m for m in seen)
    st = pipe.stream_start(runs["white10"]["w"][:12 * SR])
    assert st["legacy_source"] is None and st["snr_db"] < 25.0


def test_a_geometry_that_cannot_stream_takes_the_whole_file_path(models, pipes):
    """A 70 ms grid hop does not divide the 60 s chunk: both packages fall
    to the whole-file path (enhancement off, clean file)."""
    w, truth = make_conversation_heldout(np.random.default_rng(3), 12.0,
                                         n_speakers=2, sr=SR)
    w = w.astype(np.float32)
    jpipe, _ = pipes
    jcfg = jpipe.cfg
    try:
        jpipe.cfg = dataclasses.replace(
            jcfg, reseg=JResegConfig(hop_s=0.07),
            enhance=dataclasses.replace(jcfg.enhance, enabled=False))
        assert jpipe._streamed_start(w, SR) is None
        jres = _jax_numpy_spectral(lambda: jpipe((w, SR)))
    finally:
        jpipe.cfg = jcfg
    tpipe = DiarizationPipeline(
        port.DiarizationConfig(reseg=port.ResegConfig(hop_s=0.07),
                               enhance=port.EnhanceConfig(enabled=False)),
        encoder=models["enc"], vad=models["vad"], device="cpu")
    tres = tpipe(w)
    assert tres.diagnostics["route"] == "legacy"
    assert tres.diagnostics["enhancer"] is None
    _same_segments(tres.segments, jres.segments)


def test_a_separation_grade_demixer_is_refused(models, runs, monkeypatch,
                                               tmp_path):
    """With an HTDemucs checkpoint present the babble route demixes through
    it.  A release ``.th`` pickles the ``demucs`` class, which neither
    package can read without ``demucs`` (ROADMAP F17): the port raises,
    naming the package, instead of denoising.  Readable packages run the
    route (test_torch_htdemucs.py)."""
    import sys
    import types

    ckpt = tmp_path / "htdemucs.th"
    mods = {n: types.ModuleType(n) for n in ("demucs", "demucs.htdemucs")}
    klass = type("HTDemucs", (), {"__module__": "demucs.htdemucs"})
    mods["demucs.htdemucs"].HTDemucs = klass
    sys.modules.update(mods)
    try:
        torch.save({"klass": klass, "kwargs": {}, "state": {}}, ckpt)
    finally:
        for n in mods:
            sys.modules.pop(n)
    monkeypatch.setenv("SDTPU_DEMUCS_CKPTS", str(ckpt))
    pipe = DiarizationPipeline(port.DiarizationConfig(), encoder=models["enc"],
                               vad=models["vad"], device="cpu")
    with pytest.raises(ModuleNotFoundError, match="demucs"):
        pipe(runs["babble15"]["w"])

"""The pipeline's injected callables (``encode_fn``, ``vad_probs_fn``,
``enhance_fn``), the held-out script's weights and variables, and two
public parameters (``enhance_batch(suffix=, target_sr=)``,
``save_params_npz(store_dtype=)``), each against the JAX package on the
CPU on the same numpy-seeded inputs.

Bars: the probe-encoder pipeline's final segments equal the JAX pipeline's
with the same ``encode_fn`` (edges within 1e-6 s, labels equal) under every
clustering method; the conv VAD given as a closure gives the JAX
pipeline's segments (1e-6 s, labels equal) on the streamed path; the
GTCRN front-end given as a callable that returns a host array gives the
JAX pipeline's segments within one 10 ms frame (its GTCRN sums in another
order), labels up to renaming; the corpus worker forwards ``encode_fn``
(segments equal the JAX corpus's, 1e-6 s); an f16 store writes the bytes
the JAX function writes and loads back as the float32 of its rounding.
"""
from __future__ import annotations

import sys
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
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe
from speech_diarization_tpu.train import synthetic as jsynth
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu_torch.models.port import load_vad
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.train import synthetic as tsynth
from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout

torch.set_num_threads(2)
SR = 16000
ROOT = Path(__file__).resolve().parents[1]
WEIGHTS = ROOT / "weights"
METHODS = ("spectral", "ahc", "hdbscan", "hdbscan2")


def _jax_probe(w):
    return jnp.asarray(jsynth.spectral_probe_encoder(w))


def _port_probe(w):
    return tsynth.spectral_probe_encoder(w.cpu().numpy())


def _probe_cfg(mod, method):
    return mod.DiarizationConfig(
        audio=mod.AudioConfig(target_lufs=None, preemphasis=None),
        cluster=mod.ClusterConfig(method=method, max_speakers=6))


def _equal_segments(a, b, atol: float = 1e-6) -> None:
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a.starts, b.starts, atol=atol)
    np.testing.assert_allclose(a.ends, b.ends, atol=atol)
    np.testing.assert_array_equal(a.spks, b.spks)


@pytest.fixture(scope="module")
def probe_pipes():
    """One pipeline of each package with the probe encoder; the tests swap
    the config, which the host tail reads per call."""
    return (JPipe(_probe_cfg(jc, "spectral"), encode_fn=_jax_probe),
            DiarizationPipeline(_probe_cfg(tc, "spectral"), encode_fn=_port_probe,
                                device="cpu"))


@pytest.mark.parametrize("method", METHODS)
def test_probe_encoder_pipeline_matches_jax(probe_pipes, method):
    """``encode_fn`` alone: no shipped encoder, the windowed grid through the
    callable, the same final segments as the JAX pipeline."""
    w, _ = tsynth.make_tone_conversation(0, 3, 8)
    jpipe, tpipe = probe_pipes
    jpipe.cfg, tpipe.cfg = _probe_cfg(jc, method), _probe_cfg(tc, method)
    tres = tpipe(w)
    assert tpipe.encoder is None and tres.diagnostics["grid"] == "windowed"
    _equal_segments(tres.segments, jpipe((w, SR)).segments)


def test_encode_fn_output_lands_on_the_pipeline_device(probe_pipes):
    _, tpipe = probe_pipes
    out = tpipe.encode_fn(np.zeros((2, 16000), np.float32))
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.device == tpipe.device and out.shape == (2, 16)


def _vad_cfg(mod):
    return mod.DiarizationConfig(
        overlap=mod.OverlapConfig(enabled=False),
        enhance=mod.EnhanceConfig(enabled=False),
        cluster=mod.ClusterConfig(method="spectral"))


def test_vad_probs_fn_closure_matches_jax():
    """The shipped conv VAD as a closure (``vad_probs_fn``) on a 25 s
    draw: the streamed path, the JAX pipeline's final segments."""
    from speech_diarization_tpu.train.recipes import load_speaker_encoder as jenc
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder

    w, _ = tsynth.make_conversation(np.random.default_rng(41), 25.0,
                                    n_speakers=3, sr=SR)
    w = w.astype(np.float32)
    jvad, jvp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jpipe = JPipe(_vad_cfg(jc), encoder=jenc(WEIGHTS / "ecapa_robust_stream.npz"),
                  vad_probs_fn=jax.jit(partial(jvad.probs, jvp)))
    vad = load_vad(WEIGHTS / "vad_conv_mc.npz")
    tpipe = DiarizationPipeline(
        _vad_cfg(tc), encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad_probs_fn=lambda y: vad.probs(y), device="cpu")
    assert tpipe.vad is None
    tres = tpipe(w)
    assert tres.diagnostics["route"] == "streamed"
    _equal_segments(tres.segments, jpipe((w, SR)).segments)


def test_vad_and_vad_probs_fn_together_are_refused():
    with pytest.raises(ValueError, match="not both"):
        DiarizationPipeline(_vad_cfg(tc), encode_fn=_port_probe,
                            vad=load_vad(WEIGHTS / "vad_conv_mc.npz"),
                            vad_probs_fn=lambda y: y, device="cpu")


def test_enhance_fn_callable_matches_jax():
    """GTCRN given as ``enhance_fn`` (config's enhancement off: the callable
    is taken anyway, as in the JAX package) on a 25 s draw in white noise
    at 10 dB: the whole-file path through it in both packages; the port's
    callable returns a host array, which the pipeline moves."""
    from speech_diarization_tpu.pipelines.enhance import make_enhance_fn as jmake
    from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn

    w, _ = make_conversation_heldout(np.random.default_rng(42), 25.0, n_speakers=3,
                                     sr=SR, snr_db=10.0, noise_kind="white")
    w = w.astype(np.float32)

    def cfg(mod):
        return mod.DiarizationConfig(enhance=mod.EnhanceConfig(enabled=False),
                                     overlap=mod.OverlapConfig(enabled=False))

    gtcrn = make_enhance_fn("gtcrn", device="cpu")
    calls = []

    def enhance(y):
        calls.append(y.device)
        return gtcrn(y).numpy()

    tpipe = DiarizationPipeline(cfg(tc), enhance_fn=enhance, device="cpu")
    jpipe = JPipe(cfg(jc), enhance_fn=jmake("gtcrn"))
    tres = tpipe(w)
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        jres = jpipe((w, SR))
    finally:
        jspectral._device_capable = saved
    assert calls and tres.diagnostics["enhancer"] == "gtcrn"
    a, b = tres.segments, jres.segments
    assert len(a) == len(b) > 0
    assert np.abs(a.starts - b.starts).max() <= 0.0101
    assert np.abs(a.ends - b.ends).max() <= 0.0101
    pairs = set(zip(a.spks.tolist(), b.spks.tolist()))
    assert len(pairs) == len(set(a.spks.tolist())) == len(set(b.spks.tolist()))


def test_corpus_forwards_encode_fn():
    """``corpus_diarize(encode_fn=...)`` on two short tone files: every
    worker's pipeline takes the callable, as the JAX corpus's does."""
    from speech_diarization_tpu.pipelines.corpus import corpus_diarize as jcorpus
    from speech_diarization_tpu_torch.pipelines.corpus import corpus_diarize

    draws = [tsynth.make_tone_conversation(s, 3, 4)[0] for s in (1, 2)]
    rep = corpus_diarize(draws, _probe_cfg(tc, "ahc"), encode_fn=_port_probe,
                         device="cpu", keep_results=True)
    jrep = jcorpus([(w, SR) for w in draws], _probe_cfg(jc, "ahc"),
                   encode_fn=_jax_probe, keep_results=True)
    assert rep.errors == [] and jrep.errors == []
    ref = {f["index"]: f["result"].segments for f in jrep.files}
    for f in rep.files:
        _equal_segments(f["result"].segments, ref[f["index"]])


# ------------------------------------------------------- held-out script --
def test_heldout_script_takes_weights_and_variables(monkeypatch):
    """``--enc-weights`` / ``--vad-weights`` and the three variables reach
    the pipeline with the JAX script's meanings."""
    sys.path.insert(0, str(ROOT / "scripts"))
    import torch_eval_heldout as h

    monkeypatch.setenv("SDTPU_EVAL_REFINE", "0")
    monkeypatch.setenv("SDTPU_EVAL_OVERLAP_WEIGHTS", str(WEIGHTS / "segmentation_xf.npz"))
    monkeypatch.setenv("SDTPU_EVAL_ENHANCE_WEIGHTS", str(WEIGHTS / "gtcrn_synthetic.npz"))
    pipe, enc, vad = h.build_pipeline("cpu", str(WEIGHTS / "ecapa_proto_small.npz"),
                                      str(WEIGHTS / "vad_synthetic.npz"))
    assert (enc, vad) == ("ecapa_proto_small.npz", "vad_synthetic.npz")
    assert pipe.cfg.cluster.refine_splits is False
    assert pipe.cfg.overlap.weights.endswith("segmentation_xf.npz")
    assert pipe.cfg.enhance.weights.endswith("gtcrn_synthetic.npz")
    assert pipe.encoder.net.att_channels == 32
    assert type(pipe.vad.net).__name__ == "VadNet"
    from speech_diarization_tpu_torch.models.port import load_segmentation

    ref = load_segmentation(WEIGHTS / "segmentation_xf.npz").state_dict()
    got = pipe._overlap_seg().state_dict()
    assert ref.keys() == got.keys()
    assert all(torch.equal(got[k], ref[k]) for k in ref)
    for k in h.ENV_OVERRIDES:
        monkeypatch.delenv(k, raising=False)
    pipe, enc, vad = h.build_pipeline("cpu")
    assert (enc, vad) == ("ecapa_robust_stream.npz", "vad_conv_mc.npz")
    assert pipe.cfg.cluster.refine_splits is True
    assert pipe.cfg.overlap.weights is None and pipe.cfg.enhance.weights is None


# ------------------------------------------------------------------- F26 --
def test_enhance_batch_suffix_and_rate(tmp_path):
    """``enhance_batch`` writes ``<root><suffix>`` at ``target_sr``."""
    from speech_diarization_tpu_torch.io.audio import read_audio, write_wav
    from speech_diarization_tpu_torch.pipelines.enhance import enhance_batch

    root = tmp_path / "calls"
    w, _ = make_conversation_heldout(np.random.default_rng(43), 3.0, n_speakers=2,
                                     sr=SR, snr_db=10.0, noise_kind="white")
    write_wav(root / "a" / "x.wav", w, SR)
    out = enhance_batch(root, device="cpu", suffix="-ze", target_sr=8000)
    assert out == [tmp_path / "calls-ze" / "a" / "x.wav"]
    y, sr = read_audio(out[0], target_sr=None)
    assert sr == 8000 and len(y) == 3 * 8000
    assert enhance_batch(root, device="cpu", suffix="-ze", target_sr=8000) == []


def test_save_params_npz_float16_round_trip(tmp_path):
    """An f16 store equals the JAX function's file and loads back upcast."""
    from speech_diarization_tpu.models.port import save_params_npz as jsave
    from speech_diarization_tpu_torch.models.port import (
        load_params_meta, load_params_npz, save_params_npz,
    )

    rng = np.random.default_rng(44)
    params = {"a/w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(4), "n": np.arange(3, dtype=np.int32)}
    meta = {"arch": "conv", "refine_sub_cos": 0.6}
    save_params_npz(params, tmp_path / "t.npz", meta=meta, store_dtype=np.float16)
    jsave({k: jnp.asarray(v) for k, v in params.items()}, tmp_path / "j.npz",
          meta=meta, store_dtype=np.float16)
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k])
        assert t["a/w"].dtype == np.float16 and t["n"].dtype == np.int32
    back = load_params_npz(tmp_path / "t.npz")
    assert back["a/w"].dtype == np.float32
    np.testing.assert_array_equal(back["a/w"],
                                  params["a/w"].astype(np.float16).astype(np.float32))
    np.testing.assert_array_equal(back["n"], params["n"])
    assert load_params_meta(tmp_path / "t.npz") == meta


# ------------------------------------------------------------ the tools --
TOOLS = {"eval_rttm": [], "eval_synthetic": [], "eval_tail": [],
         "calibrate_bisect": [], "eval_vad": ["--weights", "w.npz"],
         "eval_overlap_det": [], "eval_segmentation": [], "probe_encoder": [],
         "eval_enhancer": ["--weights", "w.npz"], "eval_grid_backends": [],
         "eval_heldout": []}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_refuses_to_run_without_a_card(name, monkeypatch, capsys):
    """Without CUDA and without ``--cpu`` each tool exits 2 before any work."""
    import importlib

    sys.path.insert(0, str(ROOT / "scripts"))
    mod = importlib.import_module(f"torch_{name}")
    assert not torch.cuda.is_available()
    monkeypatch.setattr(sys, "argv", [f"torch_{name}.py", *TOOLS[name]])
    assert mod.main() == 2
    assert "needs a CUDA card (or --cpu)" in capsys.readouterr().err

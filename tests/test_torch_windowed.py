"""The windowed grid and the per-utterance encoder of the PyTorch port
against the JAX package, and kernel K1's plain version at the other shipped
attention widths.

Pieces and bars:

* ``fbank_batch`` (K2's plain version over a [B, T] batch, per-utterance
  mean-norm) at 40 and 80 mels: atol 2e-3, the bar of
  ``tests/test_pallas_fbank.py``; overlapping windows read as a strided
  view equal their contiguous copy exactly.
* ``EcapaModel.encode_batch`` (``EcapaTdnn.embed_utterances`` /
  ``asp_head``) at small widths on seeded JAX weights and with the shipped ``ecapa_synthetic.npz``:
  rel < 1e-5 in float32.
* ``embed_windows`` against the JAX ``embed_windows``: per-window cos >
  0.99999 (rel < 1e-5); a window's embedding does not depend on the batch
  size (1e-6).
* K1's plain version with zero-padded attention (A 32 and A 128, padded to
  multiples of 64 by ``EcapaTdnn.fold_k1``) against the JAX decomposed head:
  min-cos > 0.9999 and rel < 5e-3 (the bars of
  ``tests/test_asp_grid_pallas.py``); the padding changes nothing (1e-6
  against the unpadded operands).
* The pipeline on the windowed grid (``ecapa_synthetic.npz``, not
  streaming-trained) with the GRU VAD and with the energy VAD, a grid off
  the 10 ms hop with a streaming encoder (a warning, then the windowed
  grid), and the CLI's surface with ``--cluster-method ahc`` and the
  windowed encoder: final segments equal to the JAX pipeline's (edges within
  1e-6 s, labels equal).  The JAX side clusters on its numpy path.
"""
from __future__ import annotations

import argparse
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
from speech_diarization_tpu.dsp.mel import fbank_batch as jfbank_batch
from speech_diarization_tpu.models.ecapa import EcapaModel as JEcapaModel
from speech_diarization_tpu.models.ecapa import EcapaTdnn as JEcapaTdnn
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe
from speech_diarization_tpu.segment import embed_windows as jembed_windows
from speech_diarization_tpu.train.recipes import _flatten
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu_torch.dsp.mel import fbank_batch
from speech_diarization_tpu_torch.io.audio import write_wav
from speech_diarization_tpu_torch.models.ecapa import _asp_grid_stats_plain
from speech_diarization_tpu_torch.models.port import (
    load_speaker_encoder,
    load_vad,
    params_from_numpy,
)
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.segment import embed_windows

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _rel(ref, out) -> float:
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(np.linalg.norm(ref - out) / np.linalg.norm(ref))


def _cos_min(ref, out) -> float:
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    return float(((ref * out).sum(1) / (np.linalg.norm(ref, axis=1)
                                         * np.linalg.norm(out, axis=1))).min())


@pytest.fixture(scope="module")
def speech():
    w, _ = make_conversation(np.random.default_rng(21), 8.0, n_speakers=2, sr=SR)
    return w.astype(np.float32)


def _small_net(att_channels: int, seed: int = 0):
    """A JAX-initialised ECAPA at small widths (CC 96) with a non-trivial
    attention BatchNorm, carried across by ``params_from_numpy``."""
    cfg = dict(n_mels=24, channels=32, emb_dim=16, scale=4, se_channels=8,
               att_channels=att_channels)
    net = JEcapaTdnn(**cfg, dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(seed))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 7))
    a = att_channels
    params["att_bn"] = {"gamma": 1.0 + 0.1 * jax.random.normal(k1, (a,)),
                        "beta": 0.1 * jax.random.normal(k2, (a,)),
                        "mean": 0.01 * jnp.arange(a, dtype=jnp.float32),
                        "var": 1.0 + 0.01 * jnp.arange(a, dtype=jnp.float32)}
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    port = params_from_numpy(flat, {"net": {**cfg, "dilations": [2, 3, 4]}})
    return net, params, port


@pytest.mark.parametrize("n_mels", [40, 80])
def test_fbank_batch_matches_jax(speech, n_mels):
    wb = np.stack([speech[i * 1600:i * 1600 + 32000] for i in range(3)])
    ref = np.asarray(jfbank_batch(jnp.asarray(wb), SR, n_mels))
    out = fbank_batch(torch.from_numpy(wb), SR, n_mels).numpy()
    assert out.shape == ref.shape == (3, 201, n_mels)
    np.testing.assert_allclose(out, ref, atol=2e-3)


def test_fbank_batch_reads_overlapping_windows_as_a_view(speech):
    y = torch.from_numpy(speech)
    view = y[:4 * 1600 + 32000].unfold(0, 32000, 1600)
    assert view.stride() == (1600, 1)
    np.testing.assert_array_equal(fbank_batch(view, SR, 40).numpy(),
                                  fbank_batch(view.contiguous(), SR, 40).numpy())


@pytest.mark.parametrize("att", [8, 32])
def test_encode_batch_matches_jax_small_widths(speech, att):
    net, params, port = _small_net(att)
    wb = np.stack([speech[i * 4000:i * 4000 + 16000] for i in range(4)])
    ref = np.asarray(JEcapaModel(net).encode_batch(params, jnp.asarray(wb)))
    with torch.inference_mode():
        out = port.encode_batch(torch.from_numpy(wb)).numpy()
    assert out.shape == ref.shape == (4, 16)
    assert _rel(ref, out) < 1e-5


def test_encode_batch_matches_jax_shipped_encoder(speech):
    jm, jp = jload_enc(WEIGHTS / "ecapa_synthetic.npz")
    tm = load_speaker_encoder(WEIGHTS / "ecapa_synthetic.npz")
    assert not tm.streaming_trained
    wb = np.stack([speech[i * 8000:i * 8000 + 32000] for i in range(3)])
    ref = np.asarray(jm.encode_batch(jp, jnp.asarray(wb)))
    with torch.inference_mode():
        out = tm.encode_batch(torch.from_numpy(wb)).numpy()
    assert _rel(ref, out) < 1e-5


def test_embed_windows_matches_jax(speech):
    net, params, port = _small_net(8)
    jm = JEcapaModel(net)
    ref = jembed_windows(jax.jit(partial(jm.encode_batch, params)),
                         jnp.asarray(speech[:5 * SR]), SR, 1.0, 0.25, batch=8)
    with torch.inference_mode():
        out = embed_windows(port.encode_batch, torch.from_numpy(speech[:5 * SR]),
                            SR, 1.0, 0.25, batch=8).numpy()
    assert out.shape == ref.shape == (17, 16)
    assert _cos_min(ref, out) > 0.99999 and _rel(ref, out) < 1e-5


def test_embed_windows_does_not_depend_on_the_batch_size(speech):
    _, _, port = _small_net(8)
    y = torch.from_numpy(speech[:6 * SR + 123])
    with torch.inference_mode():
        a = embed_windows(port.encode_batch, y, SR, 1.0, 0.25, batch=3)
        b = embed_windows(port.encode_batch, y, SR, 1.0, 0.25, batch=64)
    assert a.shape == b.shape == (22, 16)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("att,padded", [(32, 64), (128, 128)])
def test_k1_plain_at_the_shipped_attention_widths(att, padded):
    """K1's arguments come padded to a multiple of 64 from ``fold_k1``; its
    plain version on them matches the JAX decomposed head at the Pallas
    bars, and the unpadded operands to 1e-6."""
    net, params, port = _small_net(att, seed=att)
    first_f, hop_f, win_f, n_w = 5, 4, 21, 9
    t_f = first_f + (n_w - 1) * hop_f + win_f + 3
    x = np.array(jax.random.normal(jax.random.PRNGKey(3), (96, t_f), jnp.float32))
    ref = np.asarray(net.asp_head_grid(params, jnp.asarray(x), first_f, hop_f,
                                       win_f, n_w))
    xt = torch.from_numpy(x)
    args = port.net.k1_inputs(xt, first_f, hop_f, win_f, n_w)
    assert args[2].shape == (padded, 96) and args[5].shape == (96, padded)
    stats = _asp_grid_stats_plain(*args)
    out = port.net._stats_to_emb(stats).numpy()
    assert _cos_min(ref, out) > 0.9999 and _rel(ref, out) < 5e-3
    # the same stats from the unpadded attention
    pn = port.net
    cc = 96
    mu_g, sd_g, _ = pn._window_context(xt, first_f, hop_f, win_f, n_w)
    w1 = pn.att_w1[..., 0]
    bw = mu_g @ w1[:, cc:2 * cc].T + sd_g @ w1[:, 2 * cc:].T + pn.att_b1
    inv = torch.rsqrt(pn.att_bn.var + 1e-5)
    s_bn = pn.att_bn.gamma * inv
    raw = _asp_grid_stats_plain(xt, bw, w1[:, :cc], s_bn,
                                pn.att_bn.beta - pn.att_bn.mean * s_bn,
                                pn.att_w2[..., 0], pn.att_b2, first_f, hop_f,
                                win_f, n_w)
    np.testing.assert_allclose(stats.numpy(), raw.numpy(), atol=1e-6)


def test_k1_constants_follow_the_loaded_weights():
    """K1's padded constants are refolded by every ``load_state_dict``, and
    ``nn.Module.apply`` still walks the encoder's modules."""
    _, _, a = _small_net(32, seed=1)
    _, _, b = _small_net(32, seed=2)
    a.net.load_state_dict(b.net.state_dict())
    for name in ("k1_w1x", "k1_w1m", "k1_w1s", "k1_b1", "k1_s_bn", "k1_t_bn",
                 "k1_w2"):
        np.testing.assert_array_equal(getattr(a.net, name).float().numpy(),
                                      getattr(b.net, name).float().numpy())
    seen = []
    a.apply(lambda m: seen.append(type(m).__name__))
    assert seen[-1] == "EcapaModel" and "EcapaTdnn" in seen


def _jax_numpy_spectral(fn):
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        return fn()
    finally:
        jspectral._device_capable = saved


def _same_segments(t, j) -> None:
    assert len(t) == len(j) > 0
    np.testing.assert_allclose(t.starts, j.starts, atol=1e-6)
    np.testing.assert_allclose(t.ends, j.ends, atol=1e-6)
    np.testing.assert_array_equal(t.spks, j.spks)


@pytest.fixture(scope="module")
def conversation():
    w, _ = make_conversation(np.random.default_rng(5), 15.0, n_speakers=3, sr=SR)
    return w.astype(np.float32)


@pytest.fixture(scope="module")
def windowed_encoders():
    return (jload_enc(WEIGHTS / "ecapa_synthetic.npz"),
            load_speaker_encoder(WEIGHTS / "ecapa_synthetic.npz"))


def _cfgs(**kw):
    def cfg(mod):
        return mod.DiarizationConfig(
            overlap=mod.OverlapConfig(enabled=False),
            reseg=mod.ResegConfig(**kw.get("reseg", {})),
            enhance=mod.EnhanceConfig(enabled=False))
    return cfg(jc), cfg(tc)


@pytest.mark.parametrize("vad", ["vad_synthetic.npz", None], ids=["gru", "energy"])
def test_windowed_pipeline_matches_jax(conversation, windowed_encoders, vad):
    jcfg, tcfg = _cfgs()
    jenc, tenc = windowed_encoders
    kw = {}
    if vad is not None:
        jm, jp = jload_vad(WEIGHTS / vad)
        kw["vad_probs_fn"] = jax.jit(partial(jm.probs, jp))
    jres = _jax_numpy_spectral(lambda: JPipe(jcfg, encoder=jenc, **kw)(
        (conversation, SR), collect_diagnostics=True))
    tpipe = DiarizationPipeline(tcfg, encoder=tenc, device="cpu",
                                vad=None if vad is None else load_vad(WEIGHTS / vad))
    tres = tpipe(conversation)
    assert tres.diagnostics["route"] == "legacy"
    assert tres.diagnostics["grid"] == "windowed"
    np.testing.assert_allclose(tres.diagnostics["vad_probs"],
                               jres.diagnostics["vad_probs"], atol=1e-4)
    g_t, g_j = tres.diagnostics["window_embeddings"], jres.diagnostics["window_embeddings"]
    assert g_t.shape == g_j.shape == (131, 64)
    assert _cos_min(g_j, g_t) > 0.9999
    _same_segments(tres.segments, jres.segments)


def test_an_off_hop_grid_takes_the_windowed_grid(conversation):
    """A streaming encoder on a grid that is not a multiple of the 10 ms
    mel hop: both packages warn and take the windowed grid."""
    jcfg, tcfg = _cfgs(reseg={"win_s": 1.005})
    jm, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jres = _jax_numpy_spectral(lambda: JPipe(
        jcfg, encoder=jload_enc(WEIGHTS / "ecapa_robust_stream.npz"),
        vad_probs_fn=jax.jit(partial(jm.probs, jp)))((conversation[:10 * SR], SR)))
    tres = DiarizationPipeline(
        tcfg, encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")(conversation[:10 * SR])
    assert tres.diagnostics["grid"] == "windowed"
    _same_segments(tres.segments, jres.segments)


def test_cli_ahc_with_the_windowed_encoder_matches_the_jax_cli(tmp_path,
                                                               conversation):
    """``diarize --cluster-method ahc --cos-threshold 0.6 --encoder-weights
    ecapa_synthetic.npz --vad-backend energy`` (reassignment and rescue at
    the CLI's defaults, enhancement off) in both CLIs' configurations."""
    from speech_diarization_tpu.cli import _add_common_config_args as jadd
    from speech_diarization_tpu.cli import build_config as jbuild
    from speech_diarization_tpu.cli import build_pipeline_kwargs as jkwargs
    from speech_diarization_tpu_torch.cli import (
        _add_common_config_args, build_config, build_pipeline_kwargs,
    )

    wav = tmp_path / "conv.wav"
    write_wav(wav, conversation[:12 * SR], SR)
    argv = ["--cpu", "--cluster-method", "ahc", "--cos-threshold", "0.6",
            "--encoder-weights", str(WEIGHTS / "ecapa_synthetic.npz"),
            "--vad-backend", "energy", "--enhance", "off"]

    def parse(add):
        p = argparse.ArgumentParser()
        add(p)
        return p.parse_args(argv)

    ja, ta = parse(jadd), parse(_add_common_config_args)
    jres = JPipe(jbuild(ja), **jkwargs(ja))(str(wav))
    tcfg = build_config(ta)
    assert tcfg.cluster.method == "ahc" and tcfg.cluster.cos_threshold == 0.6
    tres = DiarizationPipeline(tcfg, **build_pipeline_kwargs(ta))(str(wav))
    assert tres.diagnostics["grid"] == "windowed"
    _same_segments(tres.segments, jres.segments)


def test_cli_refuses_the_unported_encoders(tmp_path, conversation):
    """The encoders this test once saw refused now run: ``diarize --encoder
    eres2netv2|campp --encoder-weights`` with seeded 3D-Speaker checkpoints
    at the published widths (an ``.onnx`` and a ``.pt``) writes its RTTM
    on the windowed grid."""
    from speech_diarization_tpu.models.campp import CamPlusPlus as JCamPP
    from speech_diarization_tpu.models.eres2netv2 import ERes2NetV2 as JERes
    from speech_diarization_tpu_torch.cli import main
    from speech_diarization_tpu_torch.io.onnx_lite import write_initializers
    from speech_diarization_tpu_torch.models.registry import seeded_state_dict

    wav = tmp_path / "conv.wav"
    write_wav(wav, conversation[:3 * SR], SR)
    onnx = tmp_path / "eres2netv2.onnx"
    write_initializers(onnx, seeded_state_dict(JERes().manifest(), 0))
    pt = tmp_path / "campp.pt"
    torch.save({k: torch.from_numpy(v) for k, v in
                seeded_state_dict(JCamPP().manifest(), 0).items()}, pt)
    for enc, ckpt in (("eres2netv2", onnx), ("campp", pt)):
        out = tmp_path / enc
        assert main(["diarize", str(wav), "--cpu", "--encoder", enc,
                     "--encoder-weights", str(ckpt), "--out-dir", str(out)]) == 0
        assert (out / "conv.rttm").read_text().startswith("SPEAKER conv")

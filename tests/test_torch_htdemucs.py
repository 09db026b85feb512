"""The port's HTDemucs graph (``models/demucs_ref.py``), its ``.th``
importer (``models/port_demucs.py``) and the HTDemucs ensemble behind
``EnsembleDemixer``, the demix-dialog enhancer, the auto-route's demixer
and the ``demix`` subcommand, against the JAX package on the same
numpy-seeded inputs.

Both sides load one numpy draw (``models.registry.seeded_state_dict`` of
the JAX manifest; the ensembles take seeds 0, 1, 2) or the JAX ``init``
converted to numpy.  The tiny configuration is the JAX tests' (8 channels,
depth 3, nfft 512, a 16-wide bottleneck, 3 transformer layers, 2 heads);
the published one is the released ``htdemucs`` (41,471,306 values).

Bars: the transposed convolutions, GroupNorm(1), the attention and the
DConv stack within 1e-5; the sinusoidal embeddings within 1e-6 (1e-4 at
431 positions, where float32 arguments reach 430 rad); ``_spec``
and ``_ispec`` within 1e-5 of the peak, the round trip of a band-limited
signal within the JAX test's 5e-3; the graph at the tiny width and at the
published width (1 s of stereo) within 1e-5 of the output's peak, and each
item of a batch equal to it alone within 1e-6 of the peak; the ensemble's
separation within 1e-5 of the peak, the demix-dialog enhancer and the
auto-route's front-end (which resample on the host) within 1e-4 of it, the
subcommand's 16-bit stems within 1e-4.  Manifests equal the JAX ones; the
importer's refusals carry the JAX messages; a ``.th`` that pickles the ``demucs``
class is refused by both packages, naming ``demucs`` (ROADMAP F17).
"""
from __future__ import annotations

import math
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.models.demucs_ref as jdr
import speech_diarization_tpu.models.port_demucs as jpd
import speech_diarization_tpu.utils.weights as jweights
import speech_diarization_tpu_torch.models.demucs_ref as tdr
import speech_diarization_tpu_torch.models.port_demucs as tpd
import speech_diarization_tpu_torch.utils.weights as tweights
from speech_diarization_tpu.cli import main as jmain
from speech_diarization_tpu.config import DiarizationConfig as JConfig
from speech_diarization_tpu.pipelines.demix import EnsembleDemixer as JEnsemble
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipeline
from speech_diarization_tpu.pipelines.enhance import make_enhance_fn as jmake_enhance_fn
from speech_diarization_tpu_torch.cli import main
from speech_diarization_tpu_torch.config import DiarizationConfig
from speech_diarization_tpu_torch.io.audio import read_wav, write_wav
from speech_diarization_tpu_torch.models.registry import seeded_state_dict
from speech_diarization_tpu_torch.pipelines.demix import EnsembleDemixer
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn

torch.set_num_threads(2)
SR = 44100
TINY = dict(channels=8, depth=3, nfft=512, bottom_channels=16, t_layers=3, t_heads=2)


def _wave(shape, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _load(net: torch.nn.Module, params) -> torch.nn.Module:
    net.load_state_dict({k: _t(v) for k, v in params.items()}, strict=True)
    return net.eval()


def _pair(cfg: dict, seed: int = 0):
    jm = jdr.HTDemucsRef(**cfg)
    sd = seeded_state_dict(jm.manifest(), seed)
    return jm, {k: jnp.asarray(v) for k, v in sd.items()}, _load(tdr.HTDemucsRef(**cfg), sd)


@pytest.fixture(scope="module")
def tiny():
    return _pair(TINY)


# ---------------------------------------------------------- primitives ---
def test_transposed_convolutions_match(tiny):
    """The decoders' ``conv_tr`` modules against the JAX package's
    ``conv_transpose1d_torch`` / ``conv_transpose2d_freq`` (kernel 8,
    stride 4, no padding)."""
    jm, p, net = tiny
    x1, x2 = _wave((2, 8, 17), 0, 1.0), _wave((2, 8, 9, 5), 1, 1.0)
    with torch.inference_mode():
        out1 = net.tdecoder[2].conv_tr(_t(x1)).numpy()
        out2 = net.decoder[2].conv_tr(_t(x2)).numpy()
    np.testing.assert_allclose(out1, np.asarray(jdr.conv_transpose1d_torch(
        jnp.asarray(x1), p["tdecoder.2.conv_tr.weight"], p["tdecoder.2.conv_tr.bias"], 4)),
        atol=1e-5)
    np.testing.assert_allclose(out2, np.asarray(jdr.conv_transpose2d_freq(
        jnp.asarray(x2), p["decoder.2.conv_tr.weight"], p["decoder.2.conv_tr.bias"], 4)),
        atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 8, 21), (2, 6, 5, 7)], ids=["1d", "2d"])
def test_group_norm_1_matches(shape):
    rng = np.random.default_rng(2)
    x = (3.0 + rng.standard_normal(shape)).astype(np.float32)
    w, b = rng.standard_normal((2, shape[1])).astype(np.float32)
    ref = jdr.group_norm_1({"g.weight": w, "g.bias": b}, "g", jnp.asarray(x))
    np.testing.assert_allclose(tdr.group_norm_1(_t(x), _t(w), _t(b)).numpy(),
                               np.asarray(ref), atol=1e-5)


def test_attention_matches(tiny):
    """Self-attention of layer 0 and cross-attention of layer 1 (keys from
    another sequence length)."""
    jm, p, net = tiny
    q, k = _wave((2, 11, 16), 3, 1.0), _wave((2, 7, 16), 4, 1.0)
    ct = net.crosstransformer
    with torch.inference_mode():
        out_s = ct.layers[0].self_attn(_t(q), _t(q), _t(q)).numpy()
        out_c = ct.layers[1].cross_attn(_t(q), _t(k), _t(k)).numpy()
        lay_s = ct.layers_t[0](_t(q)).numpy()
        lay_c = ct.layers_t[1](_t(q), _t(k)).numpy()
    pre = "crosstransformer"
    np.testing.assert_allclose(out_s, np.asarray(jdr.multihead_attention(
        p, f"{pre}.layers.0.self_attn", q, q, q, 2)), atol=1e-5)
    np.testing.assert_allclose(out_c, np.asarray(jdr.multihead_attention(
        p, f"{pre}.layers.1.cross_attn", q, k, k, 2)), atol=1e-5)
    np.testing.assert_allclose(lay_s, np.asarray(jdr.self_attention_layer(
        p, f"{pre}.layers_t.0", jnp.asarray(q), 2)), atol=1e-5)
    np.testing.assert_allclose(lay_c, np.asarray(jdr.cross_attention_layer(
        p, f"{pre}.layers_t.1", jnp.asarray(q), jnp.asarray(k), 2)), atol=1e-5)


def test_dconv_matches(tiny):
    jm, p, net = tiny
    x = _wave((3, 8, 25), 5, 1.0)
    with torch.inference_mode():
        out = net.tencoder[0].dconv(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jdr.dconv(p, "tencoder.0.dconv", jnp.asarray(x))),
                               atol=1e-5)


@pytest.mark.parametrize("length,dim", [(6, 8), (431, 512)])
def test_sin_embeddings_match(length, dim):
    # float32 arguments reach 430 rad at 431 positions: a rounding step of
    # the argument is 3e-5 there
    atol = 1e-4 if length > 100 else 1e-6
    np.testing.assert_allclose(tdr.create_sin_embedding(length, dim).numpy(),
                               np.asarray(jdr.create_sin_embedding(length, dim)), atol=atol)
    h = 8 if dim == 512 else 5
    np.testing.assert_allclose(tdr.create_2d_sin_embedding(dim, h, length).numpy(),
                               np.asarray(jdr.create_2d_sin_embedding(dim, h, length)),
                               atol=atol)


@pytest.mark.parametrize("nfft,t", [(512, 3000), (4096, 44100)])
def test_spec_and_ispec_match(nfft, t):
    hop = nfft // 4
    x = _wave((1, 2, t), 6)
    z = tdr._spec(_t(x), nfft, hop)
    ref = np.asarray(jdr._spec(jnp.asarray(x), nfft, hop))
    assert z.shape == ref.shape == (1, 2, nfft // 2, math.ceil(t / hop))
    assert _rel(z.real.numpy(), ref.real) <= 1e-5
    assert _rel(z.imag.numpy(), ref.imag) <= 1e-5
    y = tdr._ispec(torch.from_numpy(ref.copy()), t, nfft, hop).numpy()
    assert _rel(y, np.asarray(jdr._ispec(jnp.asarray(ref), t, nfft, hop))) <= 1e-5


def test_ispec_drops_the_dc_imaginary_part():
    """As a real inverse FFT does on the CPU (the JAX ``irfft`` too): the
    port drops it explicitly, since cuFFT's inverse does not."""
    rng = np.random.default_rng(7)
    z = rng.standard_normal((1, 2, 256, 20)) + 1j * rng.standard_normal((1, 2, 256, 20))
    z_real_dc = z.copy()
    z_real_dc[..., 0, :] = z_real_dc[..., 0, :].real
    out = tdr._ispec(torch.from_numpy(z.astype(np.complex64)), 2500, 512, 128)
    ref = np.asarray(jdr._ispec(jnp.asarray(z_real_dc, jnp.complex64), 2500, 512, 128))
    assert torch.equal(out, tdr._ispec(torch.from_numpy(z_real_dc.astype(np.complex64)),
                                       2500, 512, 128))
    assert _rel(out.numpy(), ref) <= 1e-5


def test_spec_ispec_round_trip():
    """A band-limited (Brownian) signal comes back away from the first and
    last hop: the JAX test's bar."""
    nfft, hop, t = 512, 128, 2500
    x = np.cumsum(np.random.default_rng(6).standard_normal((1, 2, t)), axis=-1)
    x = (x / np.abs(x).max()).astype(np.float32)
    y = tdr._ispec(tdr._spec(_t(x), nfft, hop), t, nfft, hop).numpy()
    np.testing.assert_allclose(y[..., hop:t - hop], x[..., hop:t - hop], atol=5e-3)


# ------------------------------------------------------ graph and manifest ---
@pytest.mark.parametrize("cfg", [TINY, {}], ids=["tiny", "published"])
def test_manifest_is_the_jax_one(cfg):
    net = tdr.HTDemucsRef(**cfg)
    assert net.manifest() == jdr.HTDemucsRef(**cfg).manifest()
    if not cfg:
        assert net.param_count() == jdr.HTDemucsRef().param_count() == 41_471_306


def test_tiny_graph_matches_on_jax_init():
    jm = jdr.HTDemucsRef(**TINY)
    p = jm.init(jax.random.PRNGKey(0))
    net = _load(tdr.HTDemucsRef(**TINY), p)
    x = _wave((2, 2, 4000), 7)
    ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    with torch.inference_mode():
        out = net(_t(x)).numpy()
    assert out.shape == (2, 3, 2, 4000)
    assert _rel(out, ref) <= 1e-5


def test_tiny_graph_matches_and_ignores_the_batch(tiny):
    """Seeded weights, an odd length; each item is normalized by its own
    statistics, so a quiet item alone equals itself in the batch."""
    jm, p, net = tiny
    x = _wave((2, 2, 5003), 8)
    x[1] *= 0.01
    ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    with torch.inference_mode():
        out = net(_t(x)).numpy()
        alone = net(_t(x[1:])).numpy()
    assert _rel(out, ref) <= 1e-5
    assert _rel(alone[0], out[1]) <= 1e-6


def test_published_width_matches():
    """The released configuration on 1 s of stereo at 44.1 kHz."""
    jm, p, net = _pair({})
    x = _wave((1, 2, SR), 9)
    ref = np.asarray(jax.jit(jm.apply)(p, jnp.asarray(x)))
    with torch.inference_mode():
        out = net(_t(x)).numpy()
    assert out.shape == (1, 3, 2, SR) and np.isfinite(out).all()
    assert _rel(out, ref) <= 1e-5


# ------------------------------------------------------------ importer ---
KWARGS = {"sources": ["music", "effect", "dialog"], "audio_channels": 2, **TINY,
          "lr": 1e-4, "some_training_flag": True}


def _package(seed: int, kwargs=KWARGS) -> dict:
    """A ``demucs.states``-style package of tensors and plain values."""
    jm = jpd.model_from_kwargs(kwargs)
    state = {k: _t(v) for k, v in seeded_state_dict(jm.manifest(), seed).items()}
    return {"klass": None, "args": (), "kwargs": dict(kwargs), "state": state}


def test_model_from_kwargs_matches():
    kw = {"sources": ["music", "effect", "dialog"], "channels": 24, "nfft": 2048,
          "bottom_channels": 256, "t_layers": 3, "freq_emb": 0.3, "lr": 1e-4}
    m, jm = tpd.model_from_kwargs(kw), jpd.model_from_kwargs(kw)
    assert m.manifest() == jm.manifest()
    assert (m.sources, m.freq_emb_scale, m.nfft) == (jm.sources, 0.3, 2048)


@pytest.mark.parametrize("form", ["file", "mapping", "bare-state"])
def test_package_round_trips(tmp_path, form):
    pkg = _package(1)
    if form == "file":
        torch.save(pkg, tmp_path / "a.th")
        src, model = tmp_path / "a.th", None
    elif form == "mapping":
        src, model = pkg, None
    else:
        src, model = pkg["state"], tdr.HTDemucsRef(**TINY)
    net = tpd.load_htdemucs(src, model)
    jm, jp = jpd.load_htdemucs(pkg if form != "bare-state" else pkg["state"],
                               None if form != "bare-state" else jdr.HTDemucsRef(**TINY))
    assert not net.training and net.manifest() == jm.manifest()
    state = net.state_dict()
    for k, v in jp.items():
        np.testing.assert_array_equal(state[k].numpy(), np.asarray(v))
    x = _wave((1, 2, 3000), 10)
    with torch.inference_mode():
        out = net(_t(x)).numpy()
    assert _rel(out, np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))) <= 1e-5


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape", "diffq"])
def test_refusals_carry_the_jax_messages(fault):
    pkg = _package(2)
    state = pkg["state"]
    if fault == "missing":
        state.pop("freq_emb.embedding.weight")
    elif fault == "unexpected":
        state["decoder.9.conv_tr.weight"] = torch.zeros(3)
    elif fault == "shape":
        state["freq_emb.embedding.weight"] = torch.zeros(3, 3)
    else:
        state["__quantized"] = True
    err_type = NotImplementedError if fault == "diffq" else ValueError
    with pytest.raises(err_type) as jerr:
        jpd.load_htdemucs(pkg)
    with pytest.raises(err_type) as err:
        tpd.load_htdemucs(pkg)
    assert str(err.value) == str(jerr.value)


@pytest.fixture
def release_th(tmp_path):
    """A ``.th`` as ``demucs.states.save_model`` writes it: ``klass`` is the
    ``demucs.htdemucs.HTDemucs`` class (a stand-in registered under that
    name while the file is written)."""
    mods = {n: types.ModuleType(n) for n in ("demucs", "demucs.htdemucs")}
    klass = type("HTDemucs", (), {"__module__": "demucs.htdemucs"})
    mods["demucs.htdemucs"].HTDemucs = klass
    sys.modules.update(mods)
    try:
        pkg = _package(0)
        pkg["klass"] = klass
        torch.save(pkg, tmp_path / "97d170e1-a778de4a.th")
    finally:
        for n in mods:
            sys.modules.pop(n)
    return tmp_path / "97d170e1-a778de4a.th"


def test_a_release_th_needs_the_demucs_package_in_both(release_th):
    """ROADMAP F17: neither package can unpickle ``klass`` without
    ``demucs``; both refuse with ``ModuleNotFoundError`` naming it (through
    ``EnsembleDemixer``: ``tests/test_torch_demix.py``)."""
    with pytest.raises(ModuleNotFoundError) as jerr:
        jpd.load_htdemucs(release_th)
    with pytest.raises(ModuleNotFoundError) as err:
        tpd.load_htdemucs(release_th)
    assert jerr.value.name == err.value.name == "demucs"
    assert "demucs.htdemucs.HTDemucs" in str(err.value)


# ------------------------------------------------------------ ensemble ---
@pytest.fixture(scope="module")
def th_files(tmp_path_factory):
    """Three tiny seeded packages (seeds 0, 1, 2) as ``.th`` files."""
    base = tmp_path_factory.mktemp("th")
    paths = []
    for seed in range(3):
        paths.append(base / f"cdx23-{seed}.th")
        torch.save(_package(seed), paths[-1])
    return paths


@pytest.fixture
def ckpts_env(th_files, tmp_path, monkeypatch):
    """``SDTPU_DEMUCS_CKPTS`` naming the three files and one missing path,
    which both packages drop (ROADMAP F9)."""
    names = [str(p) for p in th_files] + [str(tmp_path / "missing.th")]
    monkeypatch.setenv("SDTPU_DEMUCS_CKPTS", ":".join(names))
    return th_files


@pytest.mark.parametrize("case", [{"t": 3 * SR}, {"t": 3 * SR, "chunk_s": 1.0}],
                         ids=["one-chunk", "chunked"])
def test_ensemble_separation_matches(ckpts_env, case):
    case = dict(case)
    t = case.pop("t")
    wav = _wave((2, t), 11)
    dmx = EnsembleDemixer(device="cpu", **case)
    assert len(dmx.nets) == 3 and isinstance(dmx.nets[0], tdr.HTDemucsRef)
    ref = JEnsemble(**case).separate(wav, SR)
    out = dmx.separate(wav, SR)
    assert out.shape == (3, 2, t)
    assert _rel(out, ref) <= 1e-5


def test_weights_root_th_files_are_the_default(th_files, monkeypatch):
    monkeypatch.delenv("SDTPU_DEMUCS_CKPTS", raising=False)
    monkeypatch.setattr(tweights, "WEIGHTS_ROOT", th_files[0].parent)
    monkeypatch.setattr(jweights, "WEIGHTS_ROOT", th_files[0].parent)
    dmx = EnsembleDemixer(device="cpu")
    assert len(dmx.nets) == 3
    wav = _wave((2, SR), 12)
    assert _rel(dmx.separate(wav, SR), JEnsemble().separate(wav, SR)) <= 1e-5


def test_an_ensemble_that_disagrees_is_refused(th_files, tmp_path, monkeypatch):
    other = tmp_path / "other.th"
    torch.save(_package(3, {**KWARGS, "channels": 16}), other)
    monkeypatch.setenv("SDTPU_DEMUCS_CKPTS", f"{th_files[0]}:{other}")
    with pytest.raises(ValueError, match="disagree on architecture") as err:
        EnsembleDemixer(device="cpu")
    with pytest.raises(ValueError) as jerr:
        JEnsemble()
    assert str(err.value) == str(jerr.value)


def test_demix_dialog_enhancer_matches(ckpts_env):
    """16 kHz mono -> 44.1 kHz stereo -> the ensemble's dialog stem ->
    16 kHz, on 3 s."""
    y = _wave(3 * 16000, 13, 0.2)
    ref = np.asarray(jmake_enhance_fn("demix-dialog")(jnp.asarray(y)))
    out = make_enhance_fn("demix-dialog", device="cpu")(_t(y)).numpy()
    assert _rel(out, ref) <= 1e-4


def test_auto_route_front_end_takes_the_ensemble(ckpts_env):
    """The auto-route's demixer is the HTDemucs ensemble in both packages,
    rescaled to the input's RMS."""
    y = _wave(3 * 16000, 14, 0.2)
    jfe = JPipeline(JConfig())._demix_frontend()
    pipe = DiarizationPipeline(DiarizationConfig(), device="cpu")
    fe = pipe._demix_frontend()
    assert fe is not None and jfe is not None
    assert _rel(fe(_t(y)).numpy(), np.asarray(jfe(jnp.asarray(y)))) <= 1e-4


def test_demix_subcommand_writes_what_the_jax_cli_writes(ckpts_env, tmp_path):
    outs = {}
    for side, fn in (("jax", jmain), ("port", main)):
        root = tmp_path / side / "in"
        write_wav(root / "a.wav", _wave((2, SR), 15, 0.2), SR)
        out = tmp_path / side / "stems"
        assert fn(["demix", str(root), "--output", str(out)]
                  + (["--cpu"] if side == "port" else [])) == 0
        outs[side] = {p.relative_to(out).as_posix(): read_wav(p)[0]
                      for p in sorted(Path(out).rglob("*.wav"))}
    assert sorted(outs["port"]) == sorted(outs["jax"]) == [
        "dialog/a.wav", "effect/a.wav", "music/a.wav"]
    for name, ref in outs["jax"].items():      # 16-bit WAVs: a step is 3.1e-5
        np.testing.assert_allclose(outs["port"][name], ref, atol=1e-4)

"""The port's demixer, its ensemble separator, resampling, the demix-dialog
enhancer, the auto-route's separation front-end and the ``demix``
subcommand against the JAX package (``models/demix.py``,
``pipelines/demix.py``, ``dsp/resample.py``, ``pipelines/enhance.py``,
``pipelines/diarize.py``, the CLI), on the same numpy-seeded inputs.

Bars: ``DialogDemixer`` at a small width on JAX-initialised weights and at
the shipped ``weights/demix_synthetic.npz`` geometry (24 channels, depth 4,
one bottleneck block) within 1e-5 of the output's peak, ``valid_length``
equal; ``EnsembleDemixer.separate`` (an ensemble of two weight sets) on one
chunk, on overlapped chunks and with two shifts within 1e-5; resampling
16 <-> 44.1 kHz within 1e-6 of the JAX device resampling and equal to
scipy's (the CPU form of ``resample_poly``); the demix-dialog enhancer within 1e-4 of the
peak.  The whole default pipeline with ``EnhanceConfig(backend=
'demix-dialog')`` on the 25 s babble draw at 15 dB of
``test_torch_legacy.py``, and the auto-route with a separation-grade
demixer present (``demix_synthetic.npz`` copied to ``demix_mc.npz`` in a
temporary weights root, in both packages): the same route, VAD
probabilities within 1e-4, final segments and DER equal.  (On the
demix-dialog backend neither package finds speech: the shipped separator's
dialog stem lies below the loudness meter's absolute gate.)  The
subcommand writes the same stems as the JAX CLI, samples within 1e-4.
"""
from __future__ import annotations

import logging
import shutil
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu.utils.weights as jweights
import speech_diarization_tpu_torch as port
import speech_diarization_tpu_torch.utils.weights as tweights
from speech_diarization_tpu.cli import main as jmain
from speech_diarization_tpu.config import DiarizationConfig as JConfig
from speech_diarization_tpu.config import EnhanceConfig as JEnhanceConfig
from speech_diarization_tpu.dsp.resample import resample_host as jresample_host
from speech_diarization_tpu.dsp.resample import resample_poly_jax
from speech_diarization_tpu.io.walk import expand_audios as jexpand_audios
from speech_diarization_tpu.metrics.der import diarization_error_rate as jder
from speech_diarization_tpu.models.demix import DialogDemixer as JDemixer
from speech_diarization_tpu.pipelines.demix import EnsembleDemixer as JEnsemble
from speech_diarization_tpu.pipelines.demix import demucs_style_read as jread
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipeline
from speech_diarization_tpu.pipelines.enhance import make_enhance_fn as jmake_enhance_fn
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu.train.recipes import load_demixer as jload_demixer
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.cli import main
from speech_diarization_tpu_torch.dsp.resample import resample_host, resample_poly
from speech_diarization_tpu_torch.io.audio import read_wav, write_wav
from speech_diarization_tpu_torch.io.walk import expand_audios
from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
from speech_diarization_tpu_torch.models.demix import DialogDemixer
from speech_diarization_tpu_torch.models.port import (
    load_demixer,
    load_speaker_encoder,
    load_vad,
)
from speech_diarization_tpu_torch.pipelines.demix import (
    EnsembleDemixer,
    demucs_style_read,
)
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
NPZ = WEIGHTS / "demix_synthetic.npz"


def _wave(shape, seed=0, scale=0.3):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _carry(net: DialogDemixer, params) -> DialogDemixer:
    net.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                        strict=True)
    return net.eval()


# ------------------------------------------------------------- the net ---
def test_state_dict_keys_and_geometry_are_the_npz_ones():
    net = load_demixer(NPZ)
    with np.load(NPZ) as data:
        assert set(net.state_dict()) == set(data.files) - {"__meta__"}
    assert (net.c, net.depth, net.k, net.s, net.nb) == (24, 4, 8, 4, 1)


@pytest.mark.parametrize("geometry", [
    {"channels": 24, "depth": 4, "kernel": 8, "stride": 4, "bottleneck_blocks": 1},
    {"channels": 48, "depth": 5, "kernel": 8, "stride": 4, "bottleneck_blocks": 2},
    {"channels": 4, "depth": 2, "kernel": 4, "stride": 2, "bottleneck_blocks": 3},
], ids=["shipped", "default", "small"])
def test_valid_length_is_the_jax_one(geometry):
    for t in (1, 7, 8, 100, 44100, 441000, 441001):
        assert DialogDemixer(**geometry).valid_length(t) == JDemixer(**geometry).valid_length(t)


def test_small_width_matches_on_jax_initialised_weights():
    jm = JDemixer(channels=8, depth=3, kernel=8, stride=4, bottleneck_blocks=2)
    params = jm.init(jax.random.PRNGKey(3))
    net = _carry(DialogDemixer(channels=8, depth=3, kernel=8, stride=4,
                               bottleneck_blocks=2), params)
    x = _wave((2, 2, 5003), 1)
    ref = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(x)))
    with torch.inference_mode():
        out = net(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 3, 2, 5003)
    assert _rel(out, ref) <= 1e-5


def test_shipped_net_matches():
    jm, jp = jload_demixer(NPZ)
    x = _wave((2, 2, 44100), 2)
    x[1] *= 0.05                      # a quiet item: its own std scales it
    ref = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(x)))
    with torch.inference_mode():
        out = load_demixer(NPZ)(torch.from_numpy(x)).numpy()
    assert _rel(out, ref) <= 1e-5


# ------------------------------------------------------- the ensemble ----
@pytest.fixture(scope="module")
def ensembles():
    """An ensemble of two weight sets at the shipped geometry: the shipped
    one and a JAX-initialised one, in both packages."""
    jm, jp = jload_demixer(NPZ)
    jp2 = jm.init(jax.random.PRNGKey(1))
    nets = [load_demixer(NPZ), _carry(load_demixer(NPZ), jp2)]
    return jm, [jp, jp2], nets


@pytest.mark.parametrize("case", [
    {"t": 30000, "chunk_s": 1.0},
    {"t": 100000, "chunk_s": 0.5},
    {"t": 60000, "chunk_s": 0.5, "shifts": 2, "max_shift_s": 0.1},
], ids=["one-chunk", "chunked", "two-shifts"])
def test_separate_matches(ensembles, case):
    jm, jparams, nets = ensembles
    case = dict(case)
    t = case.pop("t")
    wav = _wave((2, t), 4)
    ref = JEnsemble(param_sets=jparams, model=jm, **case).separate(wav, 44100)
    out = EnsembleDemixer(nets, device="cpu", **case).separate(wav, 44100)
    assert out.shape == (3, 2, t)
    assert _rel(out, ref) <= 1e-5


def test_an_htdemucs_checkpoint_is_refused(tmp_path, monkeypatch):
    """A release ``.th`` pickles the ``demucs.htdemucs.HTDemucs`` class:
    without the ``demucs`` package neither ensemble can read it, and both
    name the package (ROADMAP F17).  Readable packages load
    (``tests/test_torch_htdemucs.py``)."""
    import sys
    import types

    ckpt = tmp_path / "htdemucs.th"
    mods = {n: types.ModuleType(n) for n in ("demucs", "demucs.htdemucs")}
    klass = type("HTDemucs", (), {"__module__": "demucs.htdemucs"})
    mods["demucs.htdemucs"].HTDemucs = klass
    sys.modules.update(mods)
    try:
        torch.save({"klass": klass, "args": (), "kwargs": {}, "state": {}}, ckpt)
    finally:
        for n in mods:
            sys.modules.pop(n)
    monkeypatch.setenv("SDTPU_DEMUCS_CKPTS", str(ckpt))
    with pytest.raises(ModuleNotFoundError) as err:
        EnsembleDemixer(device="cpu")
    with pytest.raises(ModuleNotFoundError) as jerr:
        JEnsemble()
    assert err.value.name == jerr.value.name == "demucs"


def test_a_missing_checkpoint_falls_back_to_the_shipped_npz(tmp_path, monkeypatch):
    """As in the JAX package, a path that does not exist is dropped and the
    shipped npz serves (ROADMAP F9)."""
    monkeypatch.setenv("SDTPU_DEMUCS_CKPTS", str(tmp_path / "missing.th"))
    (net,) = EnsembleDemixer(device="cpu").nets
    ref = load_demixer(NPZ).state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in net.state_dict().items())


# ---------------------------------------------------------- resampling ---
@pytest.mark.parametrize("orig,target", [(16000, 44100), (44100, 16000),
                                         (16000, 16000)])
def test_resampling_matches(orig, target):
    y = _wave((3, orig // 2 + 17), 5)
    ref = jresample_host(y, orig, target)
    np.testing.assert_array_equal(resample_host(y, orig, target), ref)
    out = resample_poly(torch.from_numpy(y), orig, target).numpy()
    ref_dev = np.stack([np.asarray(resample_poly_jax(jnp.asarray(r), orig, target))
                        for r in y])
    assert out.shape == ref_dev.shape == ref.shape
    np.testing.assert_allclose(out, ref_dev, atol=1e-6)
    # on the CPU the wrapper is the host resampling, to the bit
    np.testing.assert_array_equal(out, ref)
    one = resample_poly(torch.from_numpy(y[0]), orig, target).numpy()
    np.testing.assert_array_equal(one, out[0])


# ---------------------------------------------------------- host reads ---
def test_demucs_style_read_matches(tmp_path):
    write_wav(tmp_path / "mono16k.wav", _wave(16000, 6), 16000)
    write_wav(tmp_path / "three.wav", _wave((3, 4410), 7), 44100)
    for name in ("mono16k.wav", "three.wav"):
        out, sr = demucs_style_read(tmp_path / name)
        ref, jsr = jread(tmp_path / name)
        assert sr == jsr == 44100 and out.shape[0] == 2
        np.testing.assert_allclose(out, ref, atol=1e-6)


def test_expand_audios_matches(tmp_path):
    for rel in ("a.wav", "sub/b.WAV", "sub/c.txt", "d.flac"):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_bytes(b"")
    assert expand_audios(tmp_path) == jexpand_audios(tmp_path)
    assert expand_audios(tmp_path / "a.wav") == jexpand_audios(tmp_path / "a.wav")
    assert [p.name for p in expand_audios(tmp_path)[0]] == ["a.wav", "d.flac", "b.WAV"]


# -------------------------------------------------------- the enhancer ---
def test_demix_dialog_enhancer_matches():
    """16 kHz mono -> 44.1 kHz stereo -> the dialog stem -> 16 kHz, on a
    12 s waveform (two overlapped chunks at 44.1 kHz)."""
    w, _ = make_conversation_heldout(np.random.default_rng(12), 12.0, n_speakers=2,
                                     sr=SR, snr_db=15.0, noise_kind="babble")
    y = w.astype(np.float32)
    ref = np.asarray(jmake_enhance_fn("demix-dialog")(jnp.asarray(y)))
    out = make_enhance_fn("demix-dialog", device="cpu")(torch.from_numpy(y))
    assert out.shape == y.shape
    assert _rel(out.numpy(), ref) <= 1e-4
    over = make_enhance_fn("demix-dialog", weights=str(NPZ), device="cpu")
    assert torch.equal(over(torch.from_numpy(y)), out)


# ------------------------------------------------------- the pipeline ----
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


@pytest.fixture(scope="module")
def babble():
    """The 25 s held-out draw in babble at 15 dB of test_torch_legacy.py."""
    w, truth = make_conversation_heldout(np.random.default_rng(12), 25.0,
                                         n_speakers=3, sr=SR, snr_db=15.0,
                                         noise_kind="babble")
    return w.astype(np.float32), truth


@pytest.fixture(scope="module")
def models():
    jv, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    return {"jenc": jload_enc(WEIGHTS / "ecapa_robust_stream.npz"),
            "jvad_fn": jax.jit(partial(jv.probs, jp)),
            "enc": load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
            "vad": load_vad(WEIGHTS / "vad_conv_mc.npz")}


def _run_both(models, w, backend, patch_weights=None):
    """Both packages' default pipelines with ``backend``; with
    ``patch_weights`` the weights root of both is that directory while the
    files run (the pipelines load their nets before)."""
    jpipe = JPipeline(JConfig(enhance=JEnhanceConfig(backend=backend)),
                      encoder=models["jenc"], vad_probs_fn=models["jvad_fn"])
    tpipe = DiarizationPipeline(
        port.DiarizationConfig(enhance=port.EnhanceConfig(backend=backend)),
        encoder=models["enc"], vad=models["vad"], device="cpu")
    mp = pytest.MonkeyPatch()
    if patch_weights is not None:
        mp.setattr(jweights, "WEIGHTS_ROOT", patch_weights)
        mp.setattr(tweights, "WEIGHTS_ROOT", patch_weights)
    try:
        jres = _jax_numpy_spectral(lambda: jpipe((w, SR), collect_diagnostics=True))
        tres = tpipe(w)
        jprobs = jres.diagnostics.get("vad_probs")
        if jprobs is None:
            # the JAX package's empty result carries no diagnostics: its VAD
            # probabilities from the same steps
            _, y_vad, _ = jpipe._load_waves((w, SR))
            jprobs = np.asarray(jpipe.vad_probs(y_vad, SR))
    finally:
        mp.undo()
    return jres, tres, jprobs


@pytest.fixture(scope="module")
def runs(models, babble, tmp_path_factory):
    w, _ = babble
    root = tmp_path_factory.mktemp("weights")
    shutil.copy(NPZ, root / "demix_mc.npz")
    return {"demix-dialog": _run_both(models, w, "demix-dialog"),
            "auto-route": _run_both(models, w, "gtcrn", patch_weights=root)}


@pytest.mark.parametrize("case", ["demix-dialog", "auto-route"])
def test_route_matches(runs, case):
    d = runs[case][1].diagnostics
    assert d["route"] == "legacy" and d["enhancer"] == "demix-dialog"
    assert d.get("demix_requested", False) == (case == "auto-route")


@pytest.mark.parametrize("case", ["demix-dialog", "auto-route"])
def test_vad_probs_match(runs, case):
    _, tres, jprobs = runs[case]
    a = tres.diagnostics["vad_probs"]
    assert a.shape == jprobs.shape == (25 * 100 + 1,)
    np.testing.assert_allclose(a, jprobs, atol=1e-4)


@pytest.mark.parametrize("case", ["demix-dialog", "auto-route"])
def test_final_segments_and_der_match(runs, babble, case):
    """On the demix-dialog backend the shipped ``demix_synthetic.npz``
    leaves a dialog stem some 44 dB under the input, below the loudness
    meter's absolute gate: the VAD hears silence and both packages find no
    speech.  The auto-route rescales the stem to the input's RMS."""
    jres, tres, _ = runs[case]
    a, b = tres.segments, jres.segments
    assert len(a) == len(b)
    assert (len(a) > 0) == (case == "auto-route")
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.spks, b.spks)
    truth = babble[1]
    d_jax = jder(JSegmentArray(*truth), JSegmentArray(b.starts, b.ends, b.spks)).der
    assert _der(truth, a) == pytest.approx(d_jax, abs=1e-9)


def test_the_auto_route_builds_its_demixer_once(models, babble, tmp_path):
    shutil.copy(NPZ, tmp_path / "demix_mc.npz")
    pipe = DiarizationPipeline(port.DiarizationConfig(), encoder=models["enc"],
                               vad=models["vad"], device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tweights, "WEIGHTS_ROOT", tmp_path)
    try:
        fe = pipe._demix_frontend()
        assert fe is not None and pipe._demix_frontend() is fe
    finally:
        mp.undo()


def test_without_a_separation_grade_demixer_the_route_warns_once(models, tmp_path):
    pipe = DiarizationPipeline(port.DiarizationConfig(), encoder=models["enc"],
                               vad=models["vad"], device="cpu")
    seen = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: seen.append(record.getMessage())
    logger = logging.getLogger("sdtpu.diarize")
    logger.addHandler(handler)
    mp = pytest.MonkeyPatch()
    mp.setattr(tweights, "WEIGHTS_ROOT", tmp_path)
    try:
        assert pipe._demix_frontend() is None and pipe._demix_frontend() is None
    finally:
        mp.undo()
        logger.removeHandler(handler)
    assert sum("no separation-grade demixer" in m for m in seen) == 1


# ----------------------------------------------------- the subcommand ---
def test_demix_subcommand_writes_what_the_jax_cli_writes(tmp_path):
    for side in ("jax", "port"):
        write_wav(tmp_path / side / "a.wav", _wave(24000, 8, 0.1), SR)
        write_wav(tmp_path / side / "sub" / "b.wav", _wave((2, 20000), 9, 0.1), SR)
    assert jmain(["demix", str(tmp_path / "jax"), "--output",
                  str(tmp_path / "jax-out")]) == 0
    assert main(["demix", str(tmp_path / "port"), "--cpu"]) == 0   # <root>-dialog
    trees = {side: {str(p.relative_to(root)): read_wav(p)
                    for p in sorted(root.rglob("*.wav"))}
             for side, root in (("jax", tmp_path / "jax-out"),
                                ("port", tmp_path / "port-dialog"))}
    names = [f"{s}/{f}" for s in ("dialog", "effect", "music")
             for f in ("a.wav", "sub/b.wav")]
    assert sorted(trees["port"]) == sorted(trees["jax"]) == names
    for name, (ref, sr) in trees["jax"].items():
        out, osr = trees["port"][name]
        assert osr == sr == 44100 and out.shape == ref.shape and out.shape[0] == 2
        np.testing.assert_allclose(out, ref, atol=1e-4)

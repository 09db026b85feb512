"""The port's public helpers against the JAX package's on the same
numpy-seeded inputs: preprocessing, ``mel_filterbank``, complex
``stft`` / ``istft`` and the real-pair views, ``frame_index_grid``,
``integrated_loudness_host``, ``cosine_affinity`` and
``estimate_num_speakers``, ``segment_overlap_weights``, ``parse_rttm``,
``update_params_meta``, the ``load_*_weights`` warm-start loaders, and the
tone conversation with its probe encoder.

Bars: the pure-numpy helpers (filterbank, frame grid, host loudness,
overlap weights, RTTM parsing, checkpoint meta, tone draws, probe encoder)
are equal exactly; loaded weights are equal exactly; float32 tensor
helpers are within 1e-6 of the reference's peak (elementwise) or 2e-6
(the DFT products, float32 against XLA's HIGHEST precision, sums of up to
512 terms).
"""
from __future__ import annotations

import importlib
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.cluster import affinity as jaff
from speech_diarization_tpu.cluster import spectral as jspec
from speech_diarization_tpu.dsp import framing as jframing
from speech_diarization_tpu.dsp import loudness as jloud
from speech_diarization_tpu.dsp import mel as jmel
from speech_diarization_tpu.dsp import preprocess as jpre
from speech_diarization_tpu.io.writers import parse_rttm as jparse_rttm
from speech_diarization_tpu.models import port as jport
from speech_diarization_tpu.segment.embed import segment_overlap_weights as jsow
from speech_diarization_tpu.train import recipes as jrecipes
from speech_diarization_tpu.train import synthetic as jsyn
from speech_diarization_tpu_torch.cluster import cosine_affinity, estimate_num_speakers
from speech_diarization_tpu_torch.dsp import framing, loudness, mel, preprocess
from speech_diarization_tpu_torch.io.writers import parse_rttm, write_rttm
from speech_diarization_tpu_torch.models import port
from speech_diarization_tpu_torch.segment import segment_overlap_weights
from speech_diarization_tpu_torch.train import recipes, synthetic
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(4)
# the stft modules (each dsp package exports a function of that name)
jstft = importlib.import_module("speech_diarization_tpu.dsp.stft")
tstft = importlib.import_module("speech_diarization_tpu_torch.dsp.stft")
WEIGHTS_DIR = Path(__file__).resolve().parents[1] / "weights"


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("name,kwargs", [
    ("remove_dc", {}), ("preemphasis", {"coef": 0.9}), ("peak_clip", {"limit": 0.5}),
    ("peak_normalize", {"peak": 0.8}), ("rms_normalize", {"target_db": -20.0}),
    ("preprocess_waveform", {}),
    ("preprocess_waveform", {"dc": False, "preemph": None, "clip": 0.3}),
])
def test_preprocess(name, kwargs):
    y = (np.random.default_rng(0).standard_normal((3, 4000)) * 0.6 + 0.1
         ).astype(np.float32)
    y[1] *= 0.01                                    # a row under every peak
    y[2, :3000] = 0.0                               # a long silence
    got = getattr(preprocess, name)(torch.from_numpy(y), **kwargs).numpy()
    _close(got, getattr(jpre, name)(jnp.asarray(y), **kwargs), 1e-6)


def test_mel_filterbank():
    got = mel.mel_filterbank(201, 20.0, 7900.0, 40, 16000)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jmel.mel_filterbank(201, 20.0, 7900.0, 40, 16000)))


STFT_CASES = [
    dict(n_fft=512, hop=256),
    dict(n_fft=512, hop=128, matmul=False),
    dict(n_fft=400, hop=100, win_length=320),
    dict(n_fft=256, hop=64, center=False),
    dict(n_fft=256, hop=64, window="hann"),
]


def _window(case, backend):
    case = dict(case)
    if case.pop("window", None) == "hann":
        n = case["n_fft"]
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)
        case["window"] = (jnp.asarray(w, jnp.float32) if backend == "jax"
                          else torch.tensor(w, dtype=torch.float32))
    return case


@pytest.mark.parametrize("case", STFT_CASES)
def test_complex_stft_and_istft(case):
    y = np.random.default_rng(1).standard_normal((2, 4000)).astype(np.float32)
    spec = tstft.stft(torch.from_numpy(y), **_window(case, "torch"))
    jspec_ = jstft.stft(jnp.asarray(y), **_window(case, "jax"))
    assert spec.dtype == torch.complex64
    _close(tstft.spec_as_real(spec).numpy(),
           np.asarray(jstft.spec_as_real(jspec_)), 2e-6)
    _close(tstft.stft(torch.from_numpy(y[0]), **_window(case, "torch")).numpy(),
           np.asarray(jspec_[0]), 2e-6)
    back = tstft.istft(spec, length=4000, **_window(case, "torch")).numpy()
    jback = np.asarray(jstft.istft(jspec_, length=4000, **_window(case, "jax")))
    if not case.get("center", True):
        # uncentred, the first and last half-frames divide by a squared
        # window sum near zero (1.5e-4 at sample 1), which amplifies the
        # products' rounding; hold the rest
        half = case["n_fft"] // 2
        back, jback = back[:, half:-half], jback[:, half:-half]
    _close(back, jback, 2e-6)
    if case.get("center", True):
        _close(back, y, 1e-5)                       # perfect reconstruction


def test_real_pair_views_round_trip_exactly():
    x = np.random.default_rng(2).standard_normal((3, 5, 7, 2)).astype(np.float32)
    spec = tstft.real_as_spec(torch.from_numpy(x))
    np.testing.assert_array_equal(spec.numpy(), np.asarray(jstft.real_as_spec(x)))
    np.testing.assert_array_equal(tstft.spec_as_real(spec).numpy(), x)


@pytest.mark.parametrize("n,win,hop,pad", [(1000, 400, 160, True),
                                           (1000, 400, 160, False),
                                           (100, 400, 160, True), (0, 4, 2, True)])
def test_frame_index_grid(n, win, hop, pad):
    np.testing.assert_array_equal(framing.frame_index_grid(n, win, hop, pad),
                                  jframing.frame_index_grid(n, win, hop, pad))


@pytest.mark.parametrize("fs,secs,scale", [(16000, 3.0, 0.1), (44100, 1.0, 0.3),
                                           (16000, 0.2, 0.1), (16000, 2.0, 0.0)])
def test_integrated_loudness_host(fs, secs, scale):
    y = np.random.default_rng(3).standard_normal(int(fs * secs)) * scale
    assert loudness.integrated_loudness_host(y, fs) == jloud.integrated_loudness_host(y, fs)


def test_cosine_affinity_and_speaker_count():
    e = np.random.default_rng(4).standard_normal((9, 16)).astype(np.float32)
    _close(cosine_affinity(torch.from_numpy(e)).numpy(),
           np.asarray(jaff.cosine_affinity(jnp.asarray(e))), 1e-6)
    for ev in ([0.0, 0.01, 0.02, 0.9, 0.95, 1.0, 1.1, 1.2],
               [0.0, 0.5, 0.51, 0.52, 0.53], [0.0, 0.0, 0.0, 0.0]):
        ev = np.asarray(ev, np.float32)
        for lo, hi in ((1, 8), (2, 3), (1, 1)):
            got = estimate_num_speakers(torch.from_numpy(ev), lo, hi)
            assert got.dtype == torch.int32
            assert int(got) == int(jspec.estimate_num_speakers(jnp.asarray(ev), lo, hi))


def test_segment_overlap_weights():
    g = np.random.default_rng(5)
    starts = np.sort(g.uniform(0, 20, 7))
    segs = SegmentArray(starts, starts + g.uniform(0.1, 4, 7),
                        g.integers(0, 3, 7).astype(np.int32))
    ws = np.arange(0, 20, 0.1)
    got = segment_overlap_weights(segs, ws, 2.0)
    np.testing.assert_array_equal(got, jsow(segs, ws, 2.0))


def test_parse_rttm(tmp_path):
    segs = SegmentArray(np.array([0.5, 1.25, 3.0, 4.0]), np.array([1.0, 2.5, 3.5, 6.0]),
                        np.array([7, 2, 7, 5], np.int32))
    path = tmp_path / "x.rttm"
    write_rttm(path, segs, uri="x")
    with open(path, "a", encoding="utf-8") as f:
        f.write("SPKR-INFO x 1 <NA> <NA> <NA> unknown SPK_9 <NA>\n\n")
    got, ref = parse_rttm(path), jparse_rttm(path)
    for a, b in ((got.starts, ref.starts), (got.ends, ref.ends), (got.spks, ref.spks)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(got.spks, [0, 1, 0, 2])


def test_update_params_meta(tmp_path):
    src = WEIGHTS_DIR / "ecapa_robust_stream.npz"
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    shutil.copy(src, a)
    shutil.copy(src, b)
    got = port.update_params_meta(a, refine_sub_cos=0.65, note="x")
    ref = jport.update_params_meta(b, refine_sub_cos=0.65, note="x")
    assert got == ref == port.load_params_meta(a) == jport.load_params_meta(b)
    with np.load(a) as da, np.load(b) as db, np.load(src) as ds:
        assert sorted(da.files) == sorted(db.files) == sorted(ds.files)
        for k in ds.files:
            if k != "__meta__":
                assert da[k].dtype == ds[k].dtype
                np.testing.assert_array_equal(da[k], ds[k])
    assert port.load_speaker_encoder(a).refine_sub_cos == 0.65


@pytest.mark.parametrize("name,load,dotted", [
    ("vad_conv_mc.npz", "load_vad", False),
    ("segmentation_conv.npz", "load_segmentation", False),
    ("demix_synthetic.npz", "load_demixer", True),
])
def test_warm_start_loaders(name, load, dotted):
    """``load_*_weights`` is the state dict of the net the port's loader
    builds, equal to the JAX loader's arrays key for key."""
    path = WEIGHTS_DIR / name
    sd = getattr(recipes, f"{load}_weights")(path)
    built = getattr(port, load)(path)
    net = getattr(built, "net", built)
    assert sd.keys() == net.state_dict().keys()
    for k, v in net.state_dict().items():
        assert torch.equal(sd[k], v)
    jflat = {k: np.asarray(v) for k, v in
             jrecipes._flatten(getattr(jrecipes, f"{load}_weights")(path)).items()}
    assert {port.flat_key(k, dotted) for k in sd} == set(jflat)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), jflat[port.flat_key(k, dotted)])


@pytest.mark.parametrize("seed,n_speakers,turns", [(0, 3, 8), (1, 2, 4), (7, 4, 12)])
def test_tone_conversation_and_probe_encoder(seed, n_speakers, turns):
    wave, truth = synthetic.make_tone_conversation(seed, n_speakers, turns)
    jwave, jtruth = jsyn.make_tone_conversation(seed, n_speakers, turns)
    np.testing.assert_array_equal(wave, jwave)
    for a, b in zip(truth, jtruth):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    wins = wave[: 16000 * 4].reshape(8, 8000)
    np.testing.assert_array_equal(synthetic.spectral_probe_encoder(wins),
                                  jsyn.spectral_probe_encoder(wins))

"""The port's model-level evaluation scripts (``scripts/torch_eval_overlap
_det.py``, ``torch_eval_segmentation.py``, ``torch_probe_encoder.py``,
``torch_eval_enhancer.py``, ``torch_eval_grid_backends.py``) against their
JAX counterparts on the CPU on tiny inputs: the JAX script's own functions
where it has them (``eval_segmentation.frame_eval`` / ``pipeline_eval``),
else the calls into the JAX package its ``main()`` makes, run in-process.

Bars: detector precision, recall and F1 within 0.02; best-permutation
frame accuracies within 0.02; DER within 1 point and speaker counts equal;
probe cosines within 1e-3 and EER and purity within 0.02; SI-SNR within
0.05 dB.
"""
from __future__ import annotations

import sys
from dataclasses import replace
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
WEIGHTS = ROOT / "weights"
SR = 16000
torch.set_num_threads(2)


@pytest.fixture
def numpy_spectral(monkeypatch):
    """The JAX package's spectral clustering on its numpy path, the one the
    port follows (ROADMAP F2)."""
    monkeypatch.setattr(jspectral, "_device_capable", lambda: False)


def test_overlap_detector_matches_jax():
    """``eval_overlap_det.py`` on one 30 s held-out overlap file: the JAX
    detector's regions scored by the script's arithmetic, against the
    port's summary."""
    from speech_diarization_tpu.pipelines.segmentation import make_seg_activities_fn
    from speech_diarization_tpu.segment.overlap import detect_overlap_regions
    from speech_diarization_tpu.train.recipes import load_segmentation
    from speech_diarization_tpu_torch.train.heldout import make_domain_file

    import torch_eval_overlap_det as t

    name, out = t.evaluate(None, ["heldout-overlap"], 30.0, 1, 3, device="cpu")
    assert name == "segmentation_conv.npz"
    model, params = load_segmentation(WEIGHTS / name)
    wave, (s, e, k) = make_domain_file("heldout-overlap", 0, 30.0, 3, SR)
    regions = detect_overlap_regions(np.asarray(wave, np.float32), SR,
                                     make_seg_activities_fn(model, params))
    truth = t.truth_active_counts(s, e, k, 30.0)
    pred = np.zeros(len(truth), bool)
    for a, b in zip(regions.starts, regions.ends):
        pred[int(a / 0.01): int(b / 0.01) + 1] = True
    tov = truth >= 2
    tp, fp, fn = (pred & tov).sum(), (pred & ~tov).sum(), (~pred & tov).sum()
    prec, rec = tp / max(tp + fp, 1), tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    r = out["heldout-overlap"]
    assert tp > 0
    for key, v in (("precision", prec), ("recall", rec), ("f1", f1)):
        assert abs(r[key] - v) <= 0.02, key


def test_segmentation_frame_eval_matches_jax():
    """``eval_segmentation.frame_eval`` on one batch of 2 chunks a family."""
    import eval_segmentation as j
    import torch_eval_segmentation as t

    w = WEIGHTS / "segmentation_synthetic.npz"
    out, ref = t.frame_eval(w, 1, 2, 0, "cpu"), j.frame_eval(w, 1, 2, 0)
    assert out.keys() == ref.keys()
    for fam in out:
        assert out[fam]["overlap_frame_frac"] == ref[fam]["overlap_frame_frac"]
        assert abs(out[fam]["best_perm_acc"] - ref[fam]["best_perm_acc"]) <= 0.02


def test_segmentation_pipeline_eval_matches_jax(numpy_spectral):
    """``eval_segmentation.pipeline_eval`` on one 20 s overlapping file,
    float32 encoder (the JAX script's ``--cpu``)."""
    import eval_segmentation as j
    import torch_eval_segmentation as t

    w = WEIGHTS / "segmentation_conv.npz"
    out = t.pipeline_eval(w, 1, 20.0, 3, 0.3, 0, device="cpu")
    ref = j.pipeline_eval(w, 1, 20.0, 3, 0.3, 0, cpu=True)
    for eng in ("seg_engine", "flagship"):
        for key in ("der_pct", "miss_pct", "fa_pct", "conf_pct"):
            assert abs(out[eng][key] - ref[eng][key]) <= 1.0, (eng, key)


def test_probe_encoder_matches_jax():
    """``probe_encoder.py`` at 3 speakers x 2 utterances: the JAX
    encoder's streaming grid (``vmap`` of ``encode_grid_chunk``) on the same
    renders, against the port's one ``[B, T]`` call."""
    from speech_diarization_tpu.train.multicond import render_speaker
    from speech_diarization_tpu.train.recipes import load_speaker_encoder

    import torch_probe_encoder as t

    enc = WEIGHTS / "ecapa_synthetic_full_stream.npz"
    out = t.probe(str(enc), "mixed", "off", 3, 2, 2.0, 123, device="cpu")
    wavs, labels = t.render(3, 2, 2.0, 123, "mixed", "off")
    # the renders are the JAX generator's draws
    rng = np.random.default_rng(123)
    profs = [{"f0": float(rng.uniform(85.0, 290.0)),
              "shift": float(rng.uniform(0.84, 1.24))} for _ in range(3)]
    fam = "lpc" if rng.uniform() < 0.5 else "harm"
    first = render_speaker(rng, profs[0], 2.0, SR, family=fam)[:32000]
    np.testing.assert_allclose(wavs[0, :len(first)], first, atol=1e-6)
    model, params = load_speaker_encoder(enc)
    embed = jax.jit(jax.vmap(
        lambda y: model.encode_grid_chunk(params, y, 3, 0, SR, SR // 2)))
    embs = np.asarray(embed(jnp.asarray(wavs))).mean(axis=1)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True) + 1e-9
    ref = t.scores(embs.astype(np.float64), labels, 3)
    for key in ("within_mean", "within_p10", "across_mean", "across_p90",
                "separation"):
        assert abs(out[key] - ref[key]) <= 1e-3, key
    for key in ("eer", "purity_at_true_k"):
        assert abs(out[key] - ref[key]) <= 0.02, key


@pytest.mark.parametrize("backend,weights,batch", [
    ("gtcrn", "gtcrn_mc.npz", 2), ("zipenhancer", "zipenhancer_mc.npz", 1)])
def test_enhancer_si_snr_matches_jax(backend, weights, batch):
    """``eval_enhancer.py``'s forward on both noise families."""
    from speech_diarization_tpu.models.port import load_params_npz
    from speech_diarization_tpu.train import recipes
    from speech_diarization_tpu.train.multicond import (
        ChannelBank, make_noisy_clean_batch_mc,
    )

    import torch_eval_enhancer as t

    out = t.evaluate(backend, [str(WEIGHTS / weights)], batch, 2.0, 1, "cpu")[weights]
    if backend == "gtcrn":
        from speech_diarization_tpu.dsp.stft import istft_ri, stft_ri
        from speech_diarization_tpu.models.gtcrn import GTCRN

        net = GTCRN()

        def forward(params, noisy):
            return istft_ri(net.apply(params, stft_ri(noisy, 512, 256)), 512, 256,
                            length=noisy.shape[-1])
    else:
        from speech_diarization_tpu.models.zipenhancer import ZipEnhancerModel

        forward = ZipEnhancerModel().apply
    families = {"r1": recipes.make_noisy_clean_batch,
                "mc": partial(make_noisy_clean_batch_mc,
                              channels=ChannelBank(np.random.default_rng(1)))}
    params = load_params_npz(WEIGHTS / weights)
    for name, fn in families.items():
        noisy, clean = fn(np.random.default_rng(2), batch, 2.0)
        enh = np.asarray(jax.jit(forward)(params, jnp.asarray(noisy)))
        assert abs(out[name][0] - recipes.si_snr_db(noisy, clean)) <= 1e-4
        assert abs(out[name][1] - recipes.si_snr_db(enh, clean)) <= 0.05, name


def test_grid_backends_match_jax(numpy_spectral):
    """``eval_grid_backends.py`` on one 12 s draw, both backends."""
    import speech_diarization_tpu.config as jc
    from speech_diarization_tpu.metrics.der import diarization_error_rate
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.recipes import load_speaker_encoder, load_vad
    from speech_diarization_tpu.train.synthetic import make_conversation
    from speech_diarization_tpu.types import SegmentArray
    from speech_diarization_tpu.utils.weights import ENCODER_PREFERENCE, prefer_weights

    import torch_eval_grid_backends as t

    out = t.evaluate(1, 12.0, device="cpu")
    model, params = load_speaker_encoder(prefer_weights(ENCODER_PREFERENCE))
    vad, vp = load_vad(WEIGHTS / "vad_conv_mc.npz")
    wave, (st, en, sp) = make_conversation(np.random.default_rng(100), 12.0,
                                           n_speakers=2)
    for backend in ("windowed", "streaming"):
        cfg = jc.DiarizationConfig(cluster=jc.ClusterConfig(method="spectral",
                                                             max_speakers=8))
        cfg = replace(cfg, embed=replace(cfg.embed, grid_backend=backend))
        pipe = DiarizationPipeline(cfg, encoder=(model, params),
                                   vad_probs_fn=jax.jit(partial(vad.probs, vp)))
        res = pipe((wave, SR))
        der = 100 * diarization_error_rate(SegmentArray(st, en, sp), res.segments).der
        assert out[backend]["spk"] == [res.num_speakers], backend
        assert abs(out[backend]["der_pct"] - der) <= 1.0, backend

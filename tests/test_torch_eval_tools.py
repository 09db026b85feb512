"""The port's evaluation and calibration scripts (``scripts/torch_eval_rttm
.py``, ``torch_eval_synthetic.py``, ``torch_eval_tail.py``,
``torch_calibrate_bisect.py``, ``torch_eval_vad.py``) against their JAX
counterparts on the CPU on tiny inputs: the JAX script's own functions
where it has them, else the calls into the JAX package its ``main()``
makes, run in-process.

Bars (the port's DER bars): DER and JER within 1 point; VAD miss and
false-alarm rates within 0.5 point; the calibration's ``sub_cos`` within
2e-3 per cluster, its within-cluster cosine within 2e-3 and the merged
flags equal.
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
import speech_diarization_tpu_torch.cluster.spectral as tspectral

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
WEIGHTS = ROOT / "weights"
SR = 16000
DER_PTS = 1.0
torch.set_num_threads(2)


def test_rttm_selftest_matches_jax(tmp_path):
    """One generated 20 s pair through each package's harness (the JAX
    script's ``build_pipeline`` / ``evaluate`` / ``aggregate``)."""
    from types import SimpleNamespace

    import eval_rttm as j
    import torch_eval_rttm as t

    pairs = t.selftest_pairs(tmp_path, 1, dur_s=20.0)
    vad = str(WEIGHTS / "vad_synthetic.npz")
    out = t.run(pairs, device="cpu", vad_weights=vad)
    jpipe = j.build_pipeline(SimpleNamespace(
        encoder_weights=None, vad_weights=vad, cluster="spectral", max_speakers=8))
    jrows = j.evaluate(pairs, jpipe, 0.25, False)
    jagg = j.aggregate(jrows)
    assert out["rows"][0]["ref_speech_s"] == jrows[0]["ref_speech_s"] > 0
    assert out["aggregate"]["n_files"] == jagg["n_files"] == 1
    for k in ("der", "miss", "fa", "conf", "jer"):
        assert abs(out["aggregate"][k] - jagg[k]) * 100 <= DER_PTS, k


def test_rttm_pairs_from_directories(tmp_path):
    import torch_eval_rttm as t

    pairs = t.selftest_pairs(tmp_path, 2, dur_s=3.0)
    (tmp_path / "synth1.rttm").unlink()
    assert t.find_pairs(tmp_path, tmp_path) == [pairs[0]]


def test_synthetic_table_matches_jax():
    """``eval_synthetic.py``'s table on one tone file, every method."""
    import speech_diarization_tpu.config as jc
    from speech_diarization_tpu.metrics import diarization_error_rate as jder
    from speech_diarization_tpu.metrics import jaccard_error_rate as jjer
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.synthetic import (
        make_tone_conversation, spectral_probe_encoder,
    )
    from speech_diarization_tpu.types import SegmentArray

    import torch_eval_synthetic as t

    table = t.evaluate(1, device="cpu")
    wave, (s, e, k) = make_tone_conversation(0, n_speakers=3, turns=8, sr=SR)
    truth = SegmentArray(s, e, k)
    pipe = DiarizationPipeline(
        jc.DiarizationConfig(), encode_fn=lambda w: jnp.asarray(spectral_probe_encoder(w)))
    for method in t.METHODS:
        # the host tail reads the config per call: one pipeline, one compile
        pipe.cfg = jc.DiarizationConfig(
            audio=jc.AudioConfig(target_lufs=None, preemphasis=None),
            cluster=jc.ClusterConfig(method=method, max_speakers=6))
        res = pipe((wave, SR))
        d = jder(truth, res.segments, collar_s=0.25)
        ref = {"der": d.der, "miss": d.miss, "fa": d.false_alarm,
               "conf": d.confusion, "jer": jjer(truth, res.segments, collar_s=0.25)}
        for key, v in ref.items():
            assert abs(table[method][key] - 100 * v) <= DER_PTS, (method, key)


def test_tail_matches_jax():
    """``eval_tail.py`` on seed 2000 cut to 20 s: the preferred encoder, the
    conv VAD through ``vad_probs_fn``."""
    import speech_diarization_tpu.config as jc
    from speech_diarization_tpu.metrics import diarization_error_rate as jder
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.recipes import load_speaker_encoder, load_vad
    from speech_diarization_tpu.train.synthetic import make_conversation
    from speech_diarization_tpu.types import SegmentArray
    from speech_diarization_tpu.utils.weights import ENCODER_PREFERENCE, prefer_weights

    import torch_eval_tail as t

    rows, summary = t.evaluate(seeds=(2000,), dur=20.0, device="cpu")
    model, params = load_speaker_encoder(prefer_weights(ENCODER_PREFERENCE))
    vad, vp = load_vad(WEIGHTS / "vad_conv_mc.npz")
    pipe = DiarizationPipeline(
        jc.DiarizationConfig(cluster=jc.ClusterConfig(method="spectral", max_speakers=8)),
        encoder=(model, params), vad_probs_fn=jax.jit(partial(vad.probs, vp)))
    wave, (s, e, k) = make_conversation(np.random.default_rng(2000), 20.0,
                                        n_speakers=3, sr=SR)
    res = pipe((np.asarray(wave, np.float32), SR))
    der = 100 * jder(SegmentArray(s, e, k), res.segments, collar_s=0.25).der
    assert rows[0]["spk"] == res.num_speakers
    assert abs(rows[0]["der_pct"] - der) <= DER_PTS
    assert summary["median_pct"] == summary["mean_pct"] == rows[0]["der_pct"]


def test_calibration_matches_jax(monkeypatch):
    """``calibrate_bisect.py --vad weights/vad_conv_mc.npz`` on one 60 s
    2-speaker file (seed 520) with ``ecapa_robust_stream.npz``: the JAX
    pipeline's diagnostics through the JAX ``bisect_windows``, against the
    port's statistics per cluster."""
    import speech_diarization_tpu.config as jc
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.recipes import load_speaker_encoder, load_vad
    from speech_diarization_tpu.train.synthetic import make_conversation

    import torch_calibrate_bisect as t

    enc, vad_w = str(WEIGHTS / "ecapa_robust_stream.npz"), str(WEIGHTS / "vad_conv_mc.npz")
    rows, _ = t.calibrate(enc, vad_w, "indomain", 60.0, 1, device="cpu",
                          n_speakers=(2,))
    cfg = jc.DiarizationConfig(cluster=jc.ClusterConfig(
        method="spectral", max_speakers=8, refine_splits=False))
    vad, vp = load_vad(vad_w)
    pipe = DiarizationPipeline(cfg, encoder=load_speaker_encoder(enc),
                               vad_probs_fn=jax.jit(partial(vad.probs, vp)))
    truth = make_conversation(np.random.default_rng(520), 60.0, n_speakers=2, sr=SR)
    res = pipe((truth[0], SR), collect_diagnostics=True)
    # the script's statistics on the JAX result, through the JAX bisection
    monkeypatch.setattr(tspectral, "bisect_windows", jspectral.bisect_windows)
    jrows = t.cluster_rows("indomain", 2, 0, res, truth[1])
    assert len(rows) == len(jrows) > 0
    for a, b in zip(rows, jrows):
        assert a["merged"] == b["merged"] and a["cluster"] == b["cluster"]
        assert abs(a["sub_cos"] - b["sub_cos"]) <= 2e-3
        assert abs(a["within_cos"] - b["within_cos"]) <= 2e-3
    thr = t.decide_threshold(rows)
    assert thr == -1.0 or 0.0 <= thr <= 1.0


@pytest.mark.parametrize("rows,thr", [
    ([{"sub_cos": 0.7, "merged": False}, {"sub_cos": 0.5, "merged": True}], 0.6),
    ([{"sub_cos": 0.7, "merged": False}, {"sub_cos": 0.69, "merged": True}], -1.0),
    ([{"sub_cos": 0.7, "merged": False}], 0.65),
    ([], -1.0)])
def test_calibration_threshold_rule(rows, thr):
    """The ``--write`` rule of ``calibrate_bisect.py``."""
    import torch_calibrate_bisect as t

    assert t.decide_threshold(rows) == thr


def test_calibration_write_stamps_the_meta(tmp_path):
    import shutil

    from speech_diarization_tpu_torch.models.port import load_params_meta, update_params_meta

    import torch_calibrate_bisect as t

    p = tmp_path / "enc.npz"
    shutil.copy(WEIGHTS / "ecapa_proto_small.npz", p)
    update_params_meta(p, refine_sub_cos=t.decide_threshold(
        [{"sub_cos": 0.7, "merged": False}]))
    assert load_params_meta(p)["refine_sub_cos"] == 0.65


def test_vad_scores_match_jax():
    """``eval_vad.score_weights`` on one 20 s file in two domains."""
    import eval_vad as j
    import torch_eval_vad as t

    args = (Path(WEIGHTS / "vad_conv_mc.npz"), ["indomain", "heldout-white10"], 1,
            20.0, 3)
    out, ref = t.score_weights(*args, device="cpu"), j.score_weights(*args)
    assert out.keys() == ref.keys()
    for d in out:
        for k in ("miss_pct", "fa_pct"):
            assert abs(out[d][k] - ref[d][k]) <= 0.5, (d, k)

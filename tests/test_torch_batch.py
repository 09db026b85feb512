"""The batch diarizer, the stems export and the ``batch`` / ``diag``
subcommands of the PyTorch port against the JAX package.

Pieces and bars:

* ``extract_speaker_stems``: the same files with the same 16-bit samples.
* ``run_batch`` at ``Diarizer()``'s defaults (AHC, 2-6 speakers at cos
  0.70, the default encoder, the energy VAD) with each engine on a
  directory of two 15 s WAVs: the same RTTM text and the same stem files;
  a second run skips both files (their RTTMs exist, and the stems under
  ``*-speakers`` are not taken in).  The segmentation engine clusters on
  the JAX package's numpy spectral path (ROADMAP F2).
* ``diagnose`` (whitening, HDBSCAN, AS-Norm, sticky Viterbi) on a 15 s
  file: equal segments and cluster labels, similarity statistics within
  1e-4.
* The ``batch`` and ``diag`` subcommands of both CLIs (``--cpu``,
  enhancement off): the same RTTM, the same ``diarization.json``.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu.config as jc
import speech_diarization_tpu_torch.config as tc
from speech_diarization_tpu.io.stems import extract_speaker_stems as jstems
from speech_diarization_tpu.pipelines.baseline import run_batch as jrun_batch
from speech_diarization_tpu.pipelines.diagnostic import diagnose as jdiagnose
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu.types import SegmentArray as JSegs
from speech_diarization_tpu_torch.io.audio import read_wav, write_wav
from speech_diarization_tpu_torch.io.stems import extract_speaker_stems
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.pipelines.baseline import run_batch
from speech_diarization_tpu_torch.pipelines.diagnostic import diagnose
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


@pytest.fixture(autouse=True)
def _jax_numpy_spectral():
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    yield
    jspectral._device_capable = saved


@pytest.fixture(scope="module")
def draws():
    return [make_conversation(np.random.default_rng(60 + i), 15.0, n_speakers=3,
                              sr=SR) for i in range(2)]


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _same_tree(a: Path, b: Path, suffix: str = ".wav") -> None:
    assert _files(a) == _files(b)
    for rel in _files(a):
        if rel.endswith(suffix):
            ya, sra = read_wav(a / rel)
            yb, srb = read_wav(b / rel)
            assert sra == srb
            np.testing.assert_array_equal(ya, yb)


def test_extract_speaker_stems_matches_jax(tmp_path, draws):
    wave = draws[0][0]
    rng = np.random.default_rng(8)
    starts = np.sort(rng.uniform(0.0, 13.0, 12))
    ends = starts + rng.uniform(0.3, 2.5, 12)
    spks = rng.integers(0, 3, 12)
    kw = dict(max_segment_s=4.0, max_gap_s=0.7, fade_ms=20.0, min_stem_s=1.0,
              stem_name="x")
    ref = jstems(wave, SR, JSegs(starts, ends, spks), tmp_path / "j", **kw)
    out = extract_speaker_stems(wave, SR, SegmentArray(starts, ends, spks),
                                tmp_path / "t", **kw)
    assert {k: [Path(p).name for p in v] for k, v in out.items()} == {
        k: [Path(p).name for p in v] for k, v in ref.items()}
    assert sum(len(v) for v in out.values()) >= 3
    _same_tree(tmp_path / "j", tmp_path / "t")


@pytest.mark.parametrize("engine", ["flagship", "segmentation"])
def test_run_batch_matches_jax_and_skips_what_is_done(tmp_path, draws, engine):
    for side in ("j", "t"):
        for i, (wave, _) in enumerate(draws):
            write_wav(tmp_path / side / f"draw{i}.wav", wave, SR)
    ref = jrun_batch(tmp_path / "j", engine=engine)
    out = run_batch(tmp_path / "t", engine=engine, device="cpu")
    assert [(p.name, n) for p, n in out] == [(p.name, n) for p, n in ref]
    assert len(out) == 2 and all(n > 0 for _, n in out)
    for i in range(2):
        assert ((tmp_path / "t" / f"draw{i}.rttm").read_text()
                == (tmp_path / "j" / f"draw{i}.rttm").read_text())
    _same_tree(tmp_path / "j", tmp_path / "t")
    assert any((tmp_path / "t" / "draw0-speakers").rglob("*.wav"))
    # a second run: both RTTMs exist, the stems are not audio to diarize
    assert run_batch(tmp_path / "t", engine=engine, device="cpu") == []
    assert jrun_batch(tmp_path / "j", engine=engine) == []


def test_diagnose_matches_jax(tmp_path, draws):
    wave = draws[1][0]
    jcfg = jc.DiarizationConfig(enhance=jc.EnhanceConfig(enabled=False))
    tcfg = tc.DiarizationConfig(enhance=tc.EnhanceConfig(enabled=False))
    jm, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    ref = jdiagnose((wave, SR), jcfg, out_dir=tmp_path / "j", save_plots=False,
                    encoder=jload_enc(WEIGHTS / "ecapa_robust_stream.npz"),
                    vad_probs_fn=jax.jit(partial(jm.probs, jp)))
    out = diagnose(wave, tcfg, out_dir=tmp_path / "t", save_plots=False,
                   encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
                   vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")
    assert len(out.segments) == len(ref.segments) > 0
    np.testing.assert_allclose(out.segments.starts, ref.segments.starts, atol=1e-6)
    np.testing.assert_allclose(out.segments.ends, ref.segments.ends, atol=1e-6)
    np.testing.assert_array_equal(out.segments.spks, ref.segments.spks)
    np.testing.assert_array_equal(out.labels, ref.labels)
    assert out.speakers == ref.speakers
    s_out, s_ref = out.similarity_stats(), ref.similarity_stats()
    assert s_out.keys() == s_ref.keys()
    for k in s_ref:
        assert abs(s_out[k] - s_ref[k]) < 1e-4, (k, s_out[k], s_ref[k])
    assert out.tuning_hint() == ref.tuning_hint()
    assert _files(tmp_path / "t") == _files(tmp_path / "j") == [
        "diarization.csv", "diarization.json", "diarization.srt"]
    assert ((tmp_path / "t" / "diarization.json").read_text()
            == (tmp_path / "j" / "diarization.json").read_text())


def test_batch_and_diag_subcommands_match_the_jax_cli(tmp_path, draws, capsys):
    from speech_diarization_tpu.cli import main as jmain
    from speech_diarization_tpu_torch.cli import main

    wave = draws[0][0][:12 * SR]
    for side in ("j", "t"):
        write_wav(tmp_path / side / "in" / "a.wav", wave, SR)
    common = ["--cpu", "--enhance", "off"]
    jmain(["batch", str(tmp_path / "j" / "in"), "--engine", "segmentation", *common])
    main(["batch", str(tmp_path / "t" / "in"), "--engine", "segmentation", *common])
    assert "processed 1 files" in capsys.readouterr().out
    assert ((tmp_path / "t" / "in" / "a.rttm").read_text()
            == (tmp_path / "j" / "in" / "a.rttm").read_text())
    for side, fn in (("j", jmain), ("t", main)):
        fn(["diag", str(tmp_path / side / "in" / "a.wav"), "--out-dir",
            str(tmp_path / side / "diag"), *common])
    printed = capsys.readouterr().out
    assert printed.count("adjacent cos") == 2
    assert ((tmp_path / "t" / "diag" / "diarization.json").read_text()
            == (tmp_path / "j" / "diag" / "diarization.json").read_text())
    assert _files(tmp_path / "t" / "diag") == _files(tmp_path / "j" / "diag")

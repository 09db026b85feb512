#!/usr/bin/env python
"""Real-data diarization evaluation of the PyTorch port: DER / JER against
reference RTTMs, the port of ``scripts/eval_rttm.py``.

Point it at a directory of audio files and a directory of reference
``<uri>.rttm`` files (the release format of AMI and VoxConverse): it runs
the port's pipeline on each file and scores it (collar 0.25 s, Hungarian
mapping), then prints the speech-weighted aggregate.  Without
``--audio-dir`` / ``--rttm-dir`` it scores generated conversations written
as WAV + RTTM pairs through the same file-driven code.

    python3 scripts/torch_eval_rttm.py --audio-dir AMI/wav --rttm-dir AMI/rttm \\
        [--encoder-weights ecapa.npz|embedding_model.ckpt] \\
        [--vad-weights weights/vad_synthetic.npz] [--cluster spectral] \\
        [--max-files N] [--collar 0.25] [--skip-overlap] [--cpu]

Runs on the card unless ``--cpu`` is given.  One line per file, then the
aggregate JSON line and the card's nvidia-smi line (``cpu`` under
``--cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def build_pipeline(encoder_weights: str | None = None,
                   vad_weights: str | None = "weights/vad_synthetic.npz",
                   cluster: str = "spectral", max_speakers: int = 8,
                   device=None):
    """The pipeline of ``eval_rttm.py``: the config's defaults with the
    given clustering; the encoder from ``encoder_weights`` (an ``.npz``, or
    a SpeechBrain ``embedding_model.ckpt`` through ``models/registry``; none:
    the shipped default), the VAD from ``vad_weights`` when the file exists
    (else the energy VAD)."""
    from speech_diarization_tpu_torch.config import ClusterConfig, DiarizationConfig
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline

    cfg = DiarizationConfig(
        cluster=ClusterConfig(method=cluster, max_speakers=max_speakers))
    encoder = None
    if encoder_weights:
        from speech_diarization_tpu_torch.models.registry import make_encoder_model

        encoder = make_encoder_model("ecapa", encoder_weights)
    vad = None
    if vad_weights and Path(vad_weights).exists():
        from speech_diarization_tpu_torch.models.port import load_vad

        vad = load_vad(vad_weights)
    return DiarizationPipeline(cfg, encoder=encoder, vad=vad, device=device)


def evaluate(pairs, pipe, collar: float = 0.25, skip_overlap: bool = False) -> list[dict]:
    """Per file: DER and its parts, JER and the reference speech seconds."""
    from speech_diarization_tpu_torch.io.writers import parse_rttm
    from speech_diarization_tpu_torch.metrics.der import (
        diarization_error_rate, jaccard_error_rate,
    )

    rows = []
    for audio, rttm in pairs:
        ref = parse_rttm(rttm)
        res = pipe(str(audio))
        d = diarization_error_rate(ref, res.segments, collar_s=collar,
                                   skip_overlap=skip_overlap)
        jer = jaccard_error_rate(ref, res.segments, collar_s=collar)
        rows.append({
            "uri": Path(audio).stem, "der": d.der, "miss": d.miss,
            "fa": d.false_alarm, "conf": d.confusion, "jer": jer,
            "ref_speech_s": d.total_speech_s,
        })
        print(f"{Path(audio).stem:<24} DER {d.der*100:6.2f}% "
              f"(miss {d.miss*100:5.2f} fa {d.false_alarm*100:5.2f} "
              f"conf {d.confusion*100:5.2f}) JER {jer*100:6.2f}%",
              flush=True)
    return rows


def aggregate(rows: list[dict]) -> dict:
    """Speech-weighted means of the per-file metrics."""
    w = np.asarray([r["ref_speech_s"] for r in rows])
    w = w / max(w.sum(), 1e-9)
    agg = {k: float(sum(r[k] * wi for r, wi in zip(rows, w)))
           for k in ("der", "miss", "fa", "conf", "jer")}
    agg["n_files"] = len(rows)
    return agg


def selftest_pairs(tmp: Path, n_files: int, dur_s: float = 60.0) -> list[tuple[Path, Path]]:
    """Generated 2-speaker conversations (seeds 100 + i) written as WAV +
    RTTM pairs."""
    from speech_diarization_tpu_torch.io.audio import write_wav
    from speech_diarization_tpu_torch.io.writers import write_rttm
    from speech_diarization_tpu_torch.train.synthetic import make_conversation
    from speech_diarization_tpu_torch.types import SegmentArray

    pairs = []
    for i in range(n_files):
        wave, (s, e, k) = make_conversation(
            np.random.default_rng(100 + i), dur_s, n_speakers=2)
        apath = tmp / f"synth{i}.wav"
        rpath = tmp / f"synth{i}.rttm"
        write_wav(apath, wave, 16000)
        write_rttm(rpath, SegmentArray(s, e, k), uri=apath.stem)
        pairs.append((apath, rpath))
    return pairs


def find_pairs(audio_dir: Path, rttm_dir: Path, max_files: int | None = None):
    """(audio, rttm) pairs: each audio file under ``audio_dir`` with a
    ``<stem>.rttm`` in ``rttm_dir``."""
    from speech_diarization_tpu_torch.io.walk import expand_audios

    audios, _ = expand_audios(audio_dir)
    pairs = [(a, rttm_dir / (a.stem + ".rttm")) for a in audios
             if (rttm_dir / (a.stem + ".rttm")).exists()]
    return pairs[:max_files] if max_files else pairs


def run(pairs, device=None, encoder_weights: str | None = None,
        vad_weights: str | None = "weights/vad_synthetic.npz",
        cluster: str = "spectral", max_speakers: int = 8, collar: float = 0.25,
        skip_overlap: bool = False) -> dict:
    """Score ``pairs`` with :func:`build_pipeline`'s pipeline ->
    ``{"aggregate": ..., "rows": ...}``."""
    pipe = build_pipeline(encoder_weights, vad_weights, cluster, max_speakers,
                          device=device)
    rows = evaluate(pairs, pipe, collar, skip_overlap)
    return {"aggregate": aggregate(rows), "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--audio-dir", type=Path)
    ap.add_argument("--rttm-dir", type=Path)
    ap.add_argument("--encoder-weights")
    ap.add_argument("--vad-weights", default="weights/vad_synthetic.npz")
    ap.add_argument("--cluster", default="spectral")
    ap.add_argument("--max-speakers", type=int, default=8)
    ap.add_argument("--max-files", type=int)
    ap.add_argument("--collar", type=float, default=0.25)
    ap.add_argument("--skip-overlap", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--selftest-files", type=int, default=3)
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    if args.audio_dir and args.rttm_dir:
        pairs = find_pairs(args.audio_dir, args.rttm_dir, args.max_files)
        if not pairs:
            print(f"no (audio, rttm) pairs under {args.audio_dir} / "
                  f"{args.rttm_dir}", file=sys.stderr)
            return 1
    else:
        print("no --audio-dir/--rttm-dir: running the generated-corpus selftest",
              flush=True)
        pairs = selftest_pairs(Path(tempfile.mkdtemp(prefix="sdtpu_eval_")),
                               args.selftest_files)
    out = run(pairs, device=device, encoder_weights=args.encoder_weights,
              vad_weights=args.vad_weights, cluster=args.cluster,
              max_speakers=args.max_speakers, collar=args.collar,
              skip_overlap=args.skip_overlap)
    print(json.dumps({"aggregate": out["aggregate"]}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

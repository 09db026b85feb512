#!/usr/bin/env python
"""Synthetic DER / JER table of the PyTorch port across clustering methods,
the port of ``scripts/eval_synthetic.py``: the pipeline with the
spectral-signature probe encoder (``encode_fn``) and the energy VAD on
generated tone conversations, loudness normalization and pre-emphasis off.
No checkpoint is needed.

    python3 scripts/torch_eval_synthetic.py [--n-files 4] [--turns 8] [--speakers 3] [--cpu]

Runs on the card unless ``--cpu`` is given.  One table row per method,
then the card's nvidia-smi line (``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

METHODS = ("spectral", "ahc", "hdbscan", "hdbscan2")


def probe_encode(wavs):
    """The probe encoder on a batch of windows (a tensor on any device)."""
    from speech_diarization_tpu_torch.train.synthetic import spectral_probe_encoder

    return spectral_probe_encoder(wavs.detach().cpu().numpy())


def evaluate(n_files: int = 4, turns: int = 8, speakers: int = 3,
             device=None, methods=METHODS) -> dict:
    """Mean DER / miss / false alarm / confusion / JER (%) per method over
    ``make_tone_conversation(i)`` for i < ``n_files``."""
    from speech_diarization_tpu_torch.config import (
        AudioConfig, ClusterConfig, DiarizationConfig,
    )
    from speech_diarization_tpu_torch.metrics.der import (
        diarization_error_rate, jaccard_error_rate,
    )
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.synthetic import make_tone_conversation
    from speech_diarization_tpu_torch.types import SegmentArray

    sr = 16000
    files = []
    for i in range(n_files):
        wave, (starts, ends, spks) = make_tone_conversation(
            i, n_speakers=speakers, turns=turns, sr=sr)
        files.append((wave, SegmentArray(starts, ends, spks)))
    out = {}
    for method in methods:
        cfg = DiarizationConfig(
            audio=AudioConfig(target_lufs=None, preemphasis=None),
            cluster=ClusterConfig(method=method, max_speakers=6))
        pipe = DiarizationPipeline(cfg, encode_fn=probe_encode, device=device)
        ders, jers = [], []
        for wave, truth in files:
            res = pipe((wave, sr))
            ders.append(diarization_error_rate(truth, res.segments, collar_s=0.25))
            jers.append(jaccard_error_rate(truth, res.segments, collar_s=0.25))
        out[method] = {
            "der": float(np.mean([d.der for d in ders]) * 100),
            "miss": float(np.mean([d.miss for d in ders]) * 100),
            "fa": float(np.mean([d.false_alarm for d in ders]) * 100),
            "conf": float(np.mean([d.confusion for d in ders]) * 100),
            "jer": float(np.mean(jers) * 100),
        }
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-files", type=int, default=4)
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--speakers", type=int, default=3)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    table = evaluate(args.n_files, args.turns, args.speakers, device=device)
    print(f"{'method':<10} {'DER%':>7} {'miss%':>7} {'fa%':>7} {'conf%':>7} {'JER%':>7}")
    for method, r in table.items():
        print(f"{method:<10} {r['der']:>7.2f} {r['miss']:>7.2f} {r['fa']:>7.2f} "
              f"{r['conf']:>7.2f} {r['jer']:>7.2f}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

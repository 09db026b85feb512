#!/usr/bin/env python
"""In-domain heavy-tail probe of the PyTorch port: per-seed DER of 60 s
3-speaker conversations for an encoder, the port of ``scripts/eval_tail.py``.

Seeds 2000-2005 are the documented heavy tail (near-collided speaker
profiles).  The pipeline: spectral clustering (max 8 speakers), the given
or preferred encoder (float32), and the shipped conv VAD passed as
``vad_probs_fn``.

    python3 scripts/torch_eval_tail.py [--enc weights/ecapa_robust_stream.npz] \\
        [--seeds 2000 2001 ...] [--dur 60] [--cpu]

Runs on the card unless ``--cpu`` is given.  One line per seed, the JSON
summary line, then the card's nvidia-smi line (``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def evaluate(enc: str | None = None, seeds=tuple(range(2000, 2006)),
             dur: float = 60.0, device=None) -> tuple[list[dict], dict]:
    """-> (per-seed rows, summary) as ``eval_tail.py`` prints them."""
    from speech_diarization_tpu_torch.config import ClusterConfig, DiarizationConfig
    from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.synthetic import make_conversation
    from speech_diarization_tpu_torch.types import SegmentArray
    from speech_diarization_tpu_torch.utils.device import resolve_device
    from speech_diarization_tpu_torch.utils.weights import (
        ENCODER_PREFERENCE, prefer_weights,
    )

    dev = resolve_device(device)
    enc_w = enc or prefer_weights(ENCODER_PREFERENCE)
    vad = load_vad(prefer_weights(("vad_conv_mc.npz", "vad_conv_synthetic.npz"))
                   ).to(dev).eval()
    pipe = DiarizationPipeline(
        DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8)),
        encoder=load_speaker_encoder(enc_w), vad_probs_fn=vad.probs, device=dev)
    rows = []
    for seed in seeds:
        wave, (s, e, k) = make_conversation(
            np.random.default_rng(seed), dur, n_speakers=3, sr=16000)
        res = pipe((np.asarray(wave, np.float32), 16000))
        d = diarization_error_rate(SegmentArray(s, e, k), res.segments,
                                   collar_s=0.25)
        rows.append({"seed": seed, "spk": res.num_speakers,
                     "der_pct": round(d.der * 100, 2),
                     "conf_pct": round(d.confusion * 100, 2)})
        print(rows[-1], flush=True)
    ders = [r["der_pct"] for r in rows]
    summary = {"metric": "indomain_tail", "enc": str(enc_w),
               "median_pct": round(float(np.median(ders)), 2),
               "mean_pct": round(float(np.mean(ders)), 2)}
    return rows, summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--enc", default=None)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=list(range(2000, 2006)))
    ap.add_argument("--dur", type=float, default=60.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    _, summary = evaluate(args.enc, args.seeds, args.dur, device=device)
    print(json.dumps(summary))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

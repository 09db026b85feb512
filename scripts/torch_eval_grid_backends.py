#!/usr/bin/env python
"""The windowed against the streaming window-grid backend with the PyTorch
port, the port of ``scripts/eval_grid_backends.py``.

Runs the pipeline (the shipped conv VAD as ``vad_probs_fn``, the shipped
full-size encoder or ``--weights``, spectral clustering) on generated
conversations (seeds 100 + i) once per ``EmbedConfig.grid_backend`` and
reports DER, speaker counts and wall time per backend.  The windowed grid
is every 2 s window at a 0.1 s hop through the per-utterance encoder
(512 windows a batch: one log-mel launch on a ``[512, 32000]`` view at a
row stride of 1,600); the streaming grid is the trunk-shared one.

    python3 scripts/torch_eval_grid_backends.py [--files 3] [--dur 60] [--bf16] [--cpu]

Runs on the card unless ``--cpu`` is given.  One line per file and per
backend, then the card's nvidia-smi line (``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def evaluate(files: int = 3, dur: float = 60.0, speakers: int = 2,
             bf16: bool = False, backends=("windowed", "streaming"),
             weights: str | None = None, device=None) -> dict:
    """{backend: {"der_pct", "spk", "walls"}}: mean DER (%), speaker counts
    and per-file walls (s)."""
    import torch

    from speech_diarization_tpu_torch.config import ClusterConfig, DiarizationConfig
    from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.synthetic import make_conversation
    from speech_diarization_tpu_torch.types import SegmentArray
    from speech_diarization_tpu_torch.utils.device import resolve_device
    from speech_diarization_tpu_torch.utils.weights import (
        ENCODER_PREFERENCE, WEIGHTS_ROOT, prefer_weights,
    )

    sr = 16000
    dev = resolve_device(device)
    enc_w = Path(weights) if weights else prefer_weights(ENCODER_PREFERENCE)
    encoder = load_speaker_encoder(enc_w, dtype=torch.bfloat16 if bf16 else None)
    print(f"encoder: {enc_w}", flush=True)
    vad_w = next(WEIGHTS_ROOT / n for n in ("vad_conv_mc.npz",
                                            "vad_conv_synthetic.npz",
                                            "vad_synthetic.npz")
                 if (WEIGHTS_ROOT / n).exists())
    vad = load_vad(vad_w).to(dev).eval()
    print(f"device: {dev}", flush=True)
    draws = [make_conversation(np.random.default_rng(100 + i), dur,
                               n_speakers=speakers) for i in range(files)]
    out = {}
    for backend in backends:
        cfg = DiarizationConfig(cluster=ClusterConfig(method="spectral",
                                                      max_speakers=8))
        cfg = replace(cfg, embed=replace(cfg.embed, grid_backend=backend))
        pipe = DiarizationPipeline(cfg, encoder=encoder, vad_probs_fn=vad.probs,
                                   device=dev)
        ders, spks, walls = [], [], []
        for j, (wave, (st, en, sp)) in enumerate(draws):
            t0 = time.perf_counter()
            res = pipe((wave, sr))
            wall = time.perf_counter() - t0
            d = diarization_error_rate(SegmentArray(st, en, sp), res.segments)
            ders.append(d.der)
            spks.append(res.num_speakers)
            walls.append(wall)
            print(f"  [{backend}] file{j}: DER={d.der*100:.2f}% "
                  f"spk={res.num_speakers} wall={wall:.2f}s "
                  f"(rtf={dur/wall:.0f}x)", flush=True)
        print(f"{backend}: mean DER={np.mean(ders)*100:.2f}% spk={spks} "
              f"best-wall={min(walls):.2f}s rtf={dur/min(walls):.0f}x", flush=True)
        out[backend] = {"der_pct": float(np.mean(ders) * 100), "spk": spks,
                        "walls": walls}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--files", type=int, default=3)
    ap.add_argument("--dur", type=float, default=60.0)
    ap.add_argument("--speakers", type=int, default=2)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--backends", default="windowed,streaming")
    ap.add_argument("--weights", default=None,
                    help="encoder npz (default: shipped full-size weights)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    evaluate(args.files, args.dur, args.speakers, args.bf16,
             args.backends.split(","), args.weights, device=device)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

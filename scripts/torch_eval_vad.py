#!/usr/bin/env python
"""VAD-only held-out evaluation of the PyTorch port: frame-level miss and
false-alarm rates per acoustic domain, the port of ``scripts/eval_vad.py``.

Scores a VAD checkpoint's binarized speech mask (15 s chunks through
``chunked_framewise``, the energy-floor veto, the hysteresis post) against
the generator's turns, ignoring 5 frames each side of every truth
boundary.  No encoder, no clustering.

    python3 scripts/torch_eval_vad.py --weights weights/vad_conv_mc.npz \\
        [--baseline b.npz] [--n-files 3] [--dur 60] [--domains a,b] [--cpu]

Runs on the card unless ``--cpu`` is given.  The table, the JSON summary
line, then the card's nvidia-smi line (``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def frame_truth(s, e, n_frames: int, hop_s: float) -> np.ndarray:
    """True where a frame's centre lies in a truth turn."""
    t = (np.arange(n_frames) + 0.5) * hop_s
    mask = np.zeros(n_frames, bool)
    for a, b in zip(s, e):
        mask |= (t >= a) & (t < b)
    return mask


def score_weights(path: Path, domains, n_files: int, dur_s: float,
                  n_speakers: int, collar_frames: int = 5, device=None) -> dict:
    """Mean miss and false-alarm rates (%) per domain of the VAD in
    ``path``."""
    import torch

    from speech_diarization_tpu_torch.config import VadConfig
    from speech_diarization_tpu_torch.models.port import load_vad
    from speech_diarization_tpu_torch.pipelines.chunking import chunked_framewise
    from speech_diarization_tpu_torch.segment.vad_post import (
        apply_energy_veto, vad_mask_from_probs,
    )
    from speech_diarization_tpu_torch.train.heldout import make_domain_file
    from speech_diarization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    vad = load_vad(path).to(dev).eval()
    cfg = VadConfig()
    sr, hop_s = 16000, 0.010
    hop = int(sr * hop_s)
    out = {}
    for domain in domains:
        miss, fa = [], []
        for i in range(n_files):
            wave, (s, e, k) = make_domain_file(domain, i, dur_s, n_speakers, sr)
            with torch.inference_mode():
                probs = chunked_framewise(
                    vad.probs, torch.from_numpy(np.asarray(wave, np.float32)).to(dev),
                    sr, frame_hop=hop).float().cpu().numpy()
            # the production chain's energy-floor veto, on the host
            nf = len(wave) // hop
            en = 10.0 * np.log10(
                np.mean(wave[: nf * hop].reshape(nf, hop) ** 2, -1) + 1e-12)
            gated = apply_energy_veto(probs, en, cfg)
            pred = np.asarray(vad_mask_from_probs(gated, cfg))
            truth = frame_truth(s, e, len(pred), hop_s)
            # a collar around truth boundaries is not scored
            edges = np.flatnonzero(np.diff(truth.astype(np.int8)))
            scored = np.ones(len(pred), bool)
            for ed in edges:
                scored[max(0, ed - collar_frames): ed + collar_frames + 1] = False
            t, p = truth[scored], pred[scored]
            miss.append(float((t & ~p).sum() / max(t.sum(), 1)))
            fa.append(float((~t & p).sum() / max((~t).sum(), 1)))
        out[domain] = {"miss_pct": round(100 * float(np.mean(miss)), 2),
                       "fa_pct": round(100 * float(np.mean(fa)), 2)}
    return out


def main() -> int:
    from speech_diarization_tpu_torch.train.heldout import HELDOUT_DOMAINS

    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", type=str, required=True)
    ap.add_argument("--baseline", type=str, default=None,
                    help="second checkpoint to print side by side")
    ap.add_argument("--n-files", type=int, default=3)
    ap.add_argument("--dur", type=float, default=60.0)
    ap.add_argument("--speakers", type=int, default=3)
    ap.add_argument("--domains", type=str, default=",".join(HELDOUT_DOMAINS))
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    domains = args.domains.split(",")
    res = {}
    for w in filter(None, (args.weights, args.baseline)):
        res[Path(w).name] = score_weights(Path(w), domains, args.n_files,
                                          args.dur, args.speakers, device=device)
    names = list(res)
    head = "".join(f" {n[:26]:>28}" for n in names)
    print(f"{'domain':<18}{head}")
    print(f"{'':<18}" + " ".join(f"{'miss%':>13} {'fa%':>14}" for _ in names))
    for d in domains:
        row = "".join(f" {res[n][d]['miss_pct']:>13.2f} {res[n][d]['fa_pct']:>14.2f}"
                      for n in names)
        print(f"{d:<18}{row}")
    print(json.dumps({"metric": "vad_heldout", "weights": res}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Overlap-detector quality of the PyTorch port: frame-level precision and
recall of the segmentation model's ">= 2 speakers active" decision against
the generator's truth, the port of ``scripts/eval_overlap_det.py``.

The overlap rescue consumes only this binary mask, so these numbers decide
whether the stage helps.  Per domain: overlap-frame precision / recall /
F1 (truth: >= 2 active), the false overlap rate on single-speaker frames,
the overlap rate on silence and the overlap-to-speech ratio.

    python3 scripts/torch_eval_overlap_det.py [--weights W.npz] \\
        [--domains heldout-overlap,heldout-dry,indomain] [--dur 60] \\
        [--n-files 3] [--speakers 3] [--cpu]

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

DETECTOR_PREFERENCE = ("segmentation_conv.npz", "segmentation_xf.npz",
                       "segmentation_ow3.npz", "segmentation_powerset.npz")


def truth_active_counts(s, e, k, dur_s: float, hop_s: float = 0.01) -> np.ndarray:
    """Active truth speakers per 10 ms frame."""
    n = int(dur_s / hop_s) + 1
    t = np.arange(n) * hop_s
    cnt = np.zeros(n, np.int32)
    for a, b in zip(s, e):
        cnt[(t >= a) & (t < b)] += 1
    return cnt


def hard_decisions(seg_fn):
    """The hard slot decisions of a :func:`make_seg_activities_fn` scorer:
    the top half of a dual output, else its soft activities at 0.5."""
    def fn(chunks):
        acts = seg_fn(chunks)
        if getattr(seg_fn, "dual", False):
            return acts[..., acts.shape[-1] // 2:]
        return (acts >= 0.5).float()

    return fn


def evaluate(weights: str | Path | None = None,
             domains=("heldout-overlap", "heldout-dry", "indomain"),
             dur: float = 60.0, n_files: int = 3, speakers: int = 3,
             device=None) -> tuple[str, dict]:
    """-> (the detector's file name, the summary per domain)."""
    from speech_diarization_tpu_torch.models.port import load_segmentation
    from speech_diarization_tpu_torch.pipelines.segmentation import (
        make_seg_activities_fn,
    )
    from speech_diarization_tpu_torch.segment.overlap import detect_overlap_regions
    from speech_diarization_tpu_torch.train.heldout import make_domain_file
    from speech_diarization_tpu_torch.utils.device import resolve_device
    from speech_diarization_tpu_torch.utils.weights import prefer_weights

    dev = resolve_device(device)
    w = Path(weights) if weights else prefer_weights(DETECTOR_PREFERENCE)
    if w is None:
        raise SystemExit("no segmentation weights")
    hard_fn = hard_decisions(make_seg_activities_fn(load_segmentation(w).to(dev).eval()))
    sr, hop_s = 16000, 0.01
    summary = {}
    for domain in domains:
        tp = fp = fn_ = 0
        single_total = single_fa = sil_total = sil_fa = 0
        ov_s = speech_s = 0.0
        for i in range(n_files):
            wave, (s, e, k) = make_domain_file(domain, i, dur, speakers, sr)
            truth = truth_active_counts(s, e, k, dur, hop_s)
            regions = detect_overlap_regions(np.asarray(wave, np.float32), sr,
                                             hard_fn, device=dev)
            pred = np.zeros(len(truth), bool)
            for a, b in zip(regions.starts, regions.ends):
                pred[int(a / hop_s): int(b / hop_s) + 1] = True
            pred = pred[: len(truth)]
            tov = truth >= 2
            tp += int((pred & tov).sum())
            fp += int((pred & ~tov).sum())
            fn_ += int((~pred & tov).sum())
            one = truth == 1
            single_total += int(one.sum())
            single_fa += int((pred & one).sum())
            sil = truth == 0
            sil_total += int(sil.sum())
            sil_fa += int((pred & sil).sum())
            ov_s += float((regions.ends - regions.starts).sum())
            speech_s += float(np.sum(e - s))
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn_, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-9)
        summary[domain] = {
            "precision": round(prec, 4), "recall": round(rec, 4),
            "f1": round(f1, 4),
            "false_ov_rate_single_spk_frames": round(single_fa / max(single_total, 1), 4),
            "ov_rate_silence_frames": round(sil_fa / max(sil_total, 1), 4),
            "overlap_to_speech_ratio": round(ov_s / max(speech_s, 1e-9), 4)}
    return w.name, summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", type=str, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--domains", type=str,
                    default="heldout-overlap,heldout-dry,indomain")
    ap.add_argument("--dur", type=float, default=60.0)
    ap.add_argument("--n-files", type=int, default=3)
    ap.add_argument("--speakers", type=int, default=3)
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    name, summary = evaluate(args.weights, args.domains.split(","), args.dur,
                             args.n_files, args.speakers, device=device)
    print(f"detector weights: {name}", file=sys.stderr)
    print(f"{'domain':<18} {'prec':>6} {'rec':>6} {'f1':>6} "
          f"{'fa1spk':>7} {'fa_sil':>7} {'ov/spk':>7}")
    for domain, r in summary.items():
        print(f"{domain:<18} {r['precision']:>6.3f} {r['recall']:>6.3f} "
              f"{r['f1']:>6.3f} {r['false_ov_rate_single_spk_frames']:>7.3f} "
              f"{r['ov_rate_silence_frames']:>7.3f} "
              f"{r['overlap_to_speech_ratio']:>7.3f}")
    print(json.dumps({"metric": "overlap_detector", "weights": name,
                      "domains": summary}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

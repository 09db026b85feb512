#!/usr/bin/env python
"""Segmentation-engine quality of the PyTorch port, the port of
``scripts/eval_segmentation.py``.

1. Frame level: best-permutation frame accuracy of the chunk-local
   activity model (its hard decisions), the permutation chosen per chunk,
   on batches of three generator families (in-domain, multi-condition,
   conversation), with the accuracy on overlapped frames apart.
2. Pipeline level: overlap-aware DER (collar 0.25 s, overlap scored) of
   ``segmentation_diarize`` on held-out overlapping conversations (seeds
   4000 + seed + i), beside the flagship pipeline on the same files.  The
   encoder is the preferred shipped one, bf16 on the card and float32 on
   the CPU.

    python3 scripts/torch_eval_segmentation.py [--weights W.npz] [--cpu]
    python3 scripts/torch_eval_segmentation.py --pinned   # protocol seg-eval-v1

Runs on the card unless ``--cpu`` is given.  One JSON summary line at the
end, then the card's nvidia-smi line (``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the canonical protocol: frame eval per generator family, the permutation
# per chunk, 8 batches x 8 chunks, seed 0; pipeline eval 3 x 60 s 3-speaker
# overlap-0.3 conversations, seed 0, aggregation off and on.  Bump the
# version when anything here changes.
PINNED_PROTOCOL = "seg-eval-v1"


def frame_eval(weights: Path, n_batches: int, batch: int, seed: int,
               device=None) -> dict:
    """Best-permutation frame accuracy (all frames and overlapped ones) per
    generator family."""
    import torch

    from speech_diarization_tpu_torch.models.port import load_segmentation
    from speech_diarization_tpu_torch.train.multicond import (
        make_segmentation_example_conv, make_segmentation_example_mc,
    )
    from speech_diarization_tpu_torch.train.synthetic import make_segmentation_example
    from speech_diarization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    model = load_segmentation(weights).to(dev).eval()
    out = {}
    for name, ex_fn in (("indomain", make_segmentation_example),
                        ("multicond", make_segmentation_example_mc),
                        ("conversation", make_segmentation_example_conv)):
        rng = np.random.default_rng(seed)
        accs, ov_accs, ov_frac = [], [], []
        for _ in range(n_batches):
            ws, ls = zip(*(ex_fn(rng) for _ in range(batch)))
            wavs, labels = np.stack(ws), np.stack(ls)
            with torch.inference_mode():
                act = model.hard_activities(
                    torch.from_numpy(wavs.astype(np.float32)).to(dev)).float().cpu().numpy()
            n = min(act.shape[1], labels.shape[1])
            act, labels = act[:, :n], labels[:, :n]
            ov = (labels > 0.5).sum(-1) >= 2          # >= 2 slots truly active
            ov_frac.append(float(ov.mean()))
            perms = list(itertools.permutations(range(act.shape[-1])))
            per_ex = np.stack([
                ((act[..., list(p)] > 0.5) == (labels > 0.5)).mean(axis=(1, 2))
                for p in perms])                        # [K!, B]
            ex_accs, ex_ov = [], []
            for b_i, p_i in enumerate(per_ex.argmax(axis=0)):
                ok = (act[b_i][:, list(perms[p_i])] > 0.5) == (labels[b_i] > 0.5)
                ex_accs.append(float(ok.mean()))
                if ov[b_i].any():
                    ex_ov.append(float(ok[ov[b_i]].mean()))
            accs.append(float(np.mean(ex_accs)))
            if ex_ov:
                ov_accs.append(float(np.mean(ex_ov)))
        out[name] = {
            "best_perm_acc": round(float(np.mean(accs)), 4),
            "overlap_frame_acc": round(float(np.mean(ov_accs)), 4) if ov_accs else None,
            "overlap_frame_frac": round(float(np.mean(ov_frac)), 4),
        }
        print(f"frame[{name}]: best-perm acc {out[name]['best_perm_acc']:.4f} "
              f"(overlapped frames {out[name]['overlap_frame_acc']}, "
              f"{100 * out[name]['overlap_frame_frac']:.1f}% of frames)",
              flush=True)
    return out


def pipeline_eval(weights: Path, n_files: int, dur_s: float, n_speakers: int,
                  overlap_frac: float, seed: int, aggregate: bool | None = None,
                  device=None, bf16: bool | None = None) -> dict:
    """Overlap-aware DER (%) of the segmentation engine and of the flagship
    on held-out overlapping conversations.  ``bf16``: the encoder's trunk
    dtype (None: bf16 on the card, float32 on the CPU)."""
    import torch

    from speech_diarization_tpu_torch.config import ClusterConfig, DiarizationConfig
    from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
    from speech_diarization_tpu_torch.models.port import (
        load_segmentation, load_speaker_encoder,
    )
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.pipelines.segmentation import (
        SegmentationConfig, make_seg_activities_fn, segmentation_diarize,
    )
    from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout
    from speech_diarization_tpu_torch.types import SegmentArray
    from speech_diarization_tpu_torch.utils.device import resolve_device
    from speech_diarization_tpu_torch.utils.weights import (
        ENCODER_PREFERENCE, prefer_weights,
    )

    sr = 16000
    dev = resolve_device(device)
    if bf16 is None:
        bf16 = dev.type == "cuda"
    pipe = DiarizationPipeline(
        DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8)),
        encoder=load_speaker_encoder(prefer_weights(ENCODER_PREFERENCE),
                                     dtype=torch.bfloat16 if bf16 else None),
        device=dev)
    seg_fn = make_seg_activities_fn(load_segmentation(weights).to(dev).eval())
    seg_cfg = SegmentationConfig()
    if aggregate is not None:
        seg_cfg.aggregate = aggregate
    rows = []
    for i in range(n_files):
        rng = np.random.default_rng(4000 + seed + i)
        wave, (s, e, k) = make_conversation_heldout(
            rng, dur_s, n_speakers=n_speakers, sr=sr, overlap_frac=overlap_frac)
        truth = SegmentArray(s, e, k)
        t0 = time.perf_counter()
        seg_hyp = segmentation_diarize(wave, sr, seg_fn, pipe.encode_fn, seg_cfg)
        t_seg = time.perf_counter() - t0
        t0 = time.perf_counter()
        flag_hyp = pipe((wave, sr)).segments
        t_flag = time.perf_counter() - t0
        d_seg = diarization_error_rate(truth, seg_hyp, collar_s=0.25)
        d_flag = diarization_error_rate(truth, flag_hyp, collar_s=0.25)
        rows.append((d_seg, d_flag))
        print(f"  [f{i}] seg-engine der {100 * d_seg.der:.2f}% "
              f"(miss {100 * d_seg.miss:.1f} fa {100 * d_seg.false_alarm:.1f} "
              f"conf {100 * d_seg.confusion:.1f}, {t_seg:.2f}s) | "
              f"flagship der {100 * d_flag.der:.2f}% "
              f"(miss {100 * d_flag.miss:.1f}, {t_flag:.2f}s)", file=sys.stderr)
    out = {}
    for name, idx in (("seg_engine", 0), ("flagship", 1)):
        ders = [r[idx] for r in rows]
        out[name] = {
            "der_pct": round(float(np.mean([d.der for d in ders]) * 100), 2),
            "miss_pct": round(float(np.mean([d.miss for d in ders]) * 100), 2),
            "fa_pct": round(float(np.mean([d.false_alarm for d in ders]) * 100), 2),
            "conf_pct": round(float(np.mean([d.confusion for d in ders]) * 100), 2),
        }
        print(f"pipeline[{name}]: DER {out[name]['der_pct']:.2f}% "
              f"(miss {out[name]['miss_pct']:.2f} fa {out[name]['fa_pct']:.2f} "
              f"conf {out[name]['conf_pct']:.2f})", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", type=str,
                    default=str(ROOT / "weights" / "segmentation_synthetic.npz"))
    ap.add_argument("--n-batches", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-files", type=int, default=3)
    ap.add_argument("--dur", type=float, default=60.0)
    ap.add_argument("--speakers", type=int, default=3)
    ap.add_argument("--overlap", type=float, default=0.3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--frames-only", action="store_true")
    ap.add_argument("--aggregate", choices=["on", "off"], default=None,
                    help="override SegmentationConfig.aggregate for the "
                         "pipeline eval (default: config default)")
    ap.add_argument("--pinned", action="store_true",
                    help=f"run the canonical '{PINNED_PROTOCOL}' protocol: "
                         "default frame/pipeline shapes, seed 0, pipeline "
                         "scored with aggregation off AND on")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    w = Path(args.weights)
    if args.pinned:
        out = {"metric": "segmentation_quality", "protocol": PINNED_PROTOCOL,
               "weights": w.name, "frame": frame_eval(w, 8, 8, 0, device)}
        if not args.frames_only:
            for mode, agg in (("pipeline_center_trim", False),
                              ("pipeline_aggregate", True)):
                print(f"--- pipeline eval (aggregate={agg}) ---", file=sys.stderr)
                out[mode] = pipeline_eval(w, 3, 60.0, 3, 0.3, 0, aggregate=agg,
                                          device=device)
        print(json.dumps(out))
        print(card)
        return 0
    frame = frame_eval(w, args.n_batches, args.batch, args.seed, device)
    pipe = None
    if not args.frames_only:
        agg = None if args.aggregate is None else (args.aggregate == "on")
        pipe = pipeline_eval(w, args.n_files, args.dur, args.speakers,
                             args.overlap, args.seed, aggregate=agg, device=device)
    print(json.dumps({"metric": "segmentation_quality", "weights": w.name,
                      "frame": frame, "pipeline": pipe}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

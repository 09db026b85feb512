"""Held-out-domain DER of the PyTorch port: the production pipeline (shipped
conv VAD and speaker encoder) on speech the models never trained on, the
port of ``scripts/eval_heldout.py``.

Eight domains (the in-domain generator for contrast; the held-out
source-filter synthesis dry, with reverb at RT60 0.3 and 0.6 s, in babble
at 15 and 5 dB, in white noise at 10 dB, and with 30 % overlapping turns),
``--n-files`` files of ``--dur`` seconds each (seeds 1000 + i), scored
with a 0.25 s collar: DER (miss / false alarm / confusion), JER and
speaker-count accuracy per domain.

Configuration: spectral clustering (max 8 speakers), the first shipped
VAD of ``vad_conv_mc.npz``, ``vad_conv_synthetic.npz``, ``vad_synthetic.npz``
(none: the energy VAD) or ``--vad-weights``, the first shipped encoder of
``ENCODER_PREFERENCE`` (``ecapa_robust_stream.npz``) or ``--enc-weights``
with a bf16 trunk (as ``bench.py`` loads it), the overlap rescue and the
enhancement front-end at the config's defaults.  ``SDTPU_EVAL_REFINE=0``
turns the window-driven refine splitting off; ``SDTPU_EVAL_OVERLAP=1|0``
overrides the rescue and ``SDTPU_EVAL_OVERLAP_WEIGHTS`` names its detector;
``SDTPU_EVAL_ENHANCE=off`` disables the front-end,
``=gtcrn|zipenhancer|demix-dialog`` picks it, ``SDTPU_EVAL_ENHANCE_SCOPE``
sets its scope and ``SDTPU_EVAL_ENHANCE_WEIGHTS`` its checkpoint.  The bar
is the JAX pipeline in the same configuration on the CPU on the same draws
(``scripts/torch_port_der_bar.py --heldout``): the default table (3 files
of 60 s, 3 speakers, the shipped weights, no override) exits nonzero when
a domain's DER is more than one point from it, either way.

    python3 scripts/torch_eval_heldout.py [--cpu] [--n-files 3] [--dur 60] \
        [--enc-weights X.npz] [--vad-weights V.npz]

Runs on the card unless ``--cpu`` is given.  One table row per domain on
standard output, then the card's nvidia-smi line and a JSON summary line;
per-file lines go to standard error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SR = 16000
# mean DER (%, collar 0.25 s) per domain of the JAX pipeline on the CPU in
# this configuration on the same three 60 s draws
# (scripts/torch_port_der_bar.py --heldout); the port must stay within one
# point of each when it runs the default table
JAX_CPU_HELDOUT_DER_PCT = {
    "indomain": 0.0,
    "heldout-dry": 0.0,
    "heldout-reverb3": 0.2284,
    "heldout-reverb6": 0.6575,
    "heldout-babble15": 5.2363,
    "heldout-babble5": 26.7616,
    "heldout-white10": 0.3564,
    "heldout-overlap": 2.588,
}
DER_SLACK_PCT = 1.0


ENV_OVERRIDES = ("SDTPU_EVAL_REFINE", "SDTPU_EVAL_OVERLAP",
                 "SDTPU_EVAL_OVERLAP_WEIGHTS", "SDTPU_EVAL_ENHANCE",
                 "SDTPU_EVAL_ENHANCE_SCOPE", "SDTPU_EVAL_ENHANCE_WEIGHTS")


def build_pipeline(device, enc_weights: str | None = None,
                   vad_weights: str | None = None):
    """-> (pipeline, encoder file name, VAD file name or None) of
    ``eval_heldout.py``'s configuration, the variables of
    :data:`ENV_OVERRIDES` applied."""
    import torch

    from speech_diarization_tpu_torch.config import (
        ClusterConfig, DiarizationConfig, EnhanceConfig, OverlapConfig,
    )
    from speech_diarization_tpu_torch.models.port import (
        load_speaker_encoder, load_vad,
    )
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.utils.weights import (
        ENCODER_PREFERENCE, VAD_PREFERENCE, prefer_weights,
    )

    enc_w = Path(enc_weights) if enc_weights else prefer_weights(ENCODER_PREFERENCE)
    if enc_w is None:
        raise SystemExit("no shipped encoder weights under weights/")
    vad_w = Path(vad_weights) if vad_weights else prefer_weights(VAD_PREFERENCE)
    env = os.environ.get
    enh = env("SDTPU_EVAL_ENHANCE")
    ov = env("SDTPU_EVAL_OVERLAP")
    cfg = DiarizationConfig(
        cluster=ClusterConfig(method="spectral", max_speakers=8,
                              refine_splits=env("SDTPU_EVAL_REFINE", "1") == "1"),
        overlap=OverlapConfig(**({} if ov is None else {"enabled": ov == "1"}),
                              weights=env("SDTPU_EVAL_OVERLAP_WEIGHTS")),
        enhance=EnhanceConfig(
            enabled=enh != "off",
            backend=enh if enh not in (None, "off") else "gtcrn",
            scope=env("SDTPU_EVAL_ENHANCE_SCOPE", "auto"),
            weights=env("SDTPU_EVAL_ENHANCE_WEIGHTS")))
    pipe = DiarizationPipeline(
        cfg, encoder=load_speaker_encoder(enc_w, dtype=torch.bfloat16),
        vad=None if vad_w is None else load_vad(vad_w), device=device)
    return pipe, enc_w.name, None if vad_w is None else vad_w.name


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-files", type=int, default=3)
    ap.add_argument("--dur", type=float, default=60.0)
    ap.add_argument("--speakers", type=int, default=3)
    ap.add_argument("--domains", type=str, default=None,
                    help="comma-separated subset of the eight domains")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--enc-weights", type=str, default=None)
    ap.add_argument("--vad-weights", type=str, default=None)
    args = ap.parse_args()

    from speech_diarization_tpu_torch.metrics.der import (
        diarization_error_rate, jaccard_error_rate,
    )
    from speech_diarization_tpu_torch.train.heldout import (
        HELDOUT_DOMAINS, make_domain_file,
    )
    from speech_diarization_tpu_torch.types import SegmentArray
    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    pipe, enc_name, vad_name = build_pipeline(device, args.enc_weights,
                                              args.vad_weights)
    print(f"pipeline: encoder={enc_name} vad={vad_name} cluster=spectral",
          file=sys.stderr)
    domains = args.domains.split(",") if args.domains else list(HELDOUT_DOMAINS)
    print(f"{'domain':<18} {'DER%':>7} {'miss%':>7} {'fa%':>7} {'conf%':>7} "
          f"{'JER%':>7} {'spk_acc':>8}")
    summary = {}
    for domain in domains:
        ders, jers, spk_ok, files = [], [], [], []
        for i in range(args.n_files):
            wave, truth = make_domain_file(domain, i, args.dur, args.speakers, SR)
            ref = SegmentArray(*truth)
            t0 = time.perf_counter()
            res = pipe((wave, SR))
            wall = time.perf_counter() - t0
            d = diarization_error_rate(ref, res.segments, collar_s=0.25)
            ders.append(d)
            jers.append(jaccard_error_rate(ref, res.segments, collar_s=0.25))
            n_true = len(np.unique(truth[2]))
            spk_ok.append(res.num_speakers == n_true)
            files.append(round(100.0 * d.der, 4))
            print(f"  [{domain} f{i}] der {100 * d.der:.4f}% spk "
                  f"{res.num_speakers}/{n_true} route "
                  f"{res.diagnostics.get('route')} ({wall:.2f} s)",
                  file=sys.stderr, flush=True)
        row = {k: 100.0 * float(np.mean([getattr(d, k) for d in ders]))
               for k in ("der", "miss", "false_alarm", "confusion")}
        jer, acc = 100.0 * float(np.mean(jers)), float(np.mean(spk_ok))
        print(f"{domain:<18} {row['der']:>7.2f} {row['miss']:>7.2f} "
              f"{row['false_alarm']:>7.2f} {row['confusion']:>7.2f} "
              f"{jer:>7.2f} {acc:>8.2f}", flush=True)
        summary[domain] = {"der_pct": round(row["der"], 4),
                           "jer_pct": round(jer, 4),
                           "spk_count_acc": round(acc, 4),
                           "der_pct_files": files}
    print(card)
    print(json.dumps({"metric": "heldout_der", "device": card,
                      "domains": summary}))
    default_table = (args.n_files == 3 and args.dur == 60.0 and args.speakers == 3
                     and not args.enc_weights and not args.vad_weights
                     and not any(os.environ.get(k) for k in ENV_OVERRIDES))
    off = {d: v["der_pct"] for d, v in summary.items()
           if abs(v["der_pct"] - JAX_CPU_HELDOUT_DER_PCT[d]) > DER_SLACK_PCT}
    if default_table and off:
        print(f"more than {DER_SLACK_PCT} point from the JAX CPU bar: {off}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Calibrate the window-driven bisection statistic against an encoder with
the PyTorch port, the port of ``scripts/calibrate_bisect.py``.

The split rule (``cluster/spectral.refine_labels_by_windows``) compares the
bisected sub-centroid cosine to an absolute threshold set on one encoder's
cosine scale; another encoder moves the scale.  For an encoder and a
synthesis domain this measures the bisection statistics of truly single
and truly merged clusters (1, 2 and 3 speakers, ``--files`` files each,
seeds 500 + 10 * n_spk + i), and ``--write`` stamps the decided
``refine_sub_cos`` into the checkpoint's ``__meta__`` (-1 = refine off).

    python3 scripts/torch_calibrate_bisect.py --enc weights/X.npz \\
        [--vad weights/vad_conv_mc.npz] [--domain indomain|heldout|both] \\
        [--dur 120] [--files 4] [--write] [--cpu]

Runs on the card unless ``--cpu`` is given.  One JSON line per cluster, the
summary line, the written threshold with ``--write``, then the card's
nvidia-smi line (``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _make(domain: str, seed: int, n_spk: int, dur: float):
    rng = np.random.default_rng(seed)
    if domain == "indomain":
        from speech_diarization_tpu_torch.train.synthetic import make_conversation

        return make_conversation(rng, dur, n_speakers=n_spk, sr=16000)
    from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout

    return make_conversation_heldout(rng, dur, n_speakers=n_spk, sr=16000)


def cluster_rows(domain: str, n_spk: int, i: int, res, truth) -> list[dict]:
    """The bisection statistics of each cluster of one diarized file with at
    least 100 windows wholly inside its segments."""
    from speech_diarization_tpu_torch.cluster.spectral import bisect_windows

    ts, te, tk = truth
    d = res.diagnostics
    wemb = np.asarray(d["window_embeddings"], np.float64)
    wstart = np.asarray(d["window_starts_s"])
    segs = res.segments
    starts, ends = np.asarray(segs.starts), np.asarray(segs.ends)
    spks = np.asarray(segs.spks)
    if len(wemb) == 0 or len(starts) == 0:
        return []
    e = wemb / (np.linalg.norm(wemb, axis=1, keepdims=True) + 1e-9)
    # the segment each window lies wholly inside
    order = np.argsort(starts)
    pos = np.searchsorted(starts[order], wstart, side="right") - 1
    cand = order[np.clip(pos, 0, None)]
    inside = (pos >= 0) & (wstart + 1.0 <= ends[cand] + 1e-9)
    # the true speaker of each window by its centre sample
    wmid = wstart + 0.5
    wpos = np.searchsorted(ts, wmid, side="right") - 1
    wspk = tk[np.clip(wpos, 0, None)]
    rows = []
    for c in np.unique(spks[spks >= 0]):
        member = np.where(spks == c)[0]
        wmask = inside & np.isin(cand, member)
        if wmask.sum() < 100:
            continue
        we = e[wmask]
        sub_cos, _ = bisect_windows(we)
        cent = we.mean(0)
        cent /= np.linalg.norm(cent) + 1e-9
        within = float((we @ cent).mean())
        comp = np.bincount(np.searchsorted(np.unique(wspk[wmask]), wspk[wmask]))
        maj_frac = float(comp.max() / comp.sum())
        # merged: the minority truth speaker holds >= 20 % of the windows
        rows.append({
            "domain": domain, "n_spk": n_spk, "file": i, "cluster": int(c),
            "windows": int(wmask.sum()),
            "sub_cos": round(float(sub_cos), 4),
            "within_cos": round(within, 4),
            "rel": round(float(sub_cos) / (within + 1e-9), 4),
            "maj_frac": round(maj_frac, 3),
            "merged": bool(maj_frac <= 0.8),
        })
    return rows


def calibrate(enc: str = "weights/ecapa_synthetic_full_stream.npz",
              vad: str | None = None, domain: str = "indomain",
              dur: float = 120.0, files: int = 4, device=None,
              n_speakers=(1, 2, 3)) -> tuple[list[dict], dict | None]:
    """-> (one row per scored cluster, the summary or None when merged or
    single clusters are missing)."""
    from speech_diarization_tpu_torch.config import ClusterConfig, DiarizationConfig
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    kw = {}
    if vad:
        kw["vad_probs_fn"] = load_vad(vad).to(dev).eval().probs
    cfg = DiarizationConfig(cluster=ClusterConfig(
        method="spectral", max_speakers=8, refine_splits=False))
    pipe = DiarizationPipeline(cfg, encoder=load_speaker_encoder(enc),
                               device=dev, **kw)
    domains = ["indomain", "heldout"] if domain == "both" else [domain]
    rows = []
    for dom in domains:
        for n_spk in n_speakers:
            for i in range(files):
                wave, truth = _make(dom, 500 + 10 * n_spk + i, n_spk, dur)
                res = pipe((wave, 16000), collect_diagnostics=True)
                rows += cluster_rows(dom, n_spk, i, res, truth)
    merged = [r for r in rows if r["merged"]]
    single = [r for r in rows if not r["merged"]]
    summary = None
    if merged and single:
        summary = {
            "single_sub_cos_min": min(r["sub_cos"] for r in single),
            "merged_sub_cos_max": max(r["sub_cos"] for r in merged),
            "single_rel_min": min(r["rel"] for r in single),
            "merged_rel_max": max(r["rel"] for r in merged),
        }
    return rows, summary


def decide_threshold(rows: list[dict]) -> float:
    """The encoder's ``refine_sub_cos`` (a split fires at sub_cos <= it):
    the midpoint of the gap when merged and single clusters separate by
    more than 0.02, just below every single when there are no merged ones,
    else -1.0 (refine off)."""
    merged = [r["sub_cos"] for r in rows if r["merged"]]
    single = [r["sub_cos"] for r in rows if not r["merged"]]
    thr = -1.0
    if single:
        smin = min(single)
        if merged:
            mmax = max(merged)
            if mmax < smin - 0.02:
                thr = round((mmax + smin) / 2.0, 4)
        else:
            thr = round(max(smin - 0.05, 0.0), 4)
    return thr


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--enc", default="weights/ecapa_synthetic_full_stream.npz")
    ap.add_argument("--vad", default=None)
    ap.add_argument("--domain", choices=["indomain", "heldout", "both"],
                    default="indomain")
    ap.add_argument("--dur", type=float, default=120.0)
    ap.add_argument("--files", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    ap.add_argument("--write", action="store_true",
                    help="stamp the decided refine_sub_cos into the "
                         "checkpoint's __meta__ (-1 = refine off)")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    rows, summary = calibrate(args.enc, args.vad, args.domain, args.dur,
                              args.files, device=device)
    for r in rows:
        print(json.dumps(r))
    if summary is not None:
        print(json.dumps(summary))
    if args.write:
        from speech_diarization_tpu_torch.models.port import update_params_meta

        thr = decide_threshold(rows)
        update_params_meta(args.enc, refine_sub_cos=thr)
        print(json.dumps({"written": args.enc, "refine_sub_cos": thr,
                          "n_single": sum(not r["merged"] for r in rows),
                          "n_merged": sum(r["merged"] for r in rows)}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The host tail's clustering at one BLAS thread against the default pool, by
file length.

    python3 scripts/torch_tail_threads.py [--lengths 35,117,260,600,1800]
        [--reps 5] [--seed 7] [--cpu] --out tail_threads.json

For each length, one ``make_conversation`` draw (2 speakers at 35 s, 3 at
117 and 260 s as on calls, 4 from 600 s on as in meetings) goes through
the ``diarizer_default`` configuration's pipeline (built as
``perfbench/harness`` builds it) with ``collect_diagnostics``; on the
file's own window and segment embeddings the script then times
``spectral_cluster`` and ``refine_labels_by_windows`` (as clustered, and
with the first two clusters merged into one so that the refine has a pair
to split) and the whole ``_segments_from_grid``, alternating the process's
default BLAS pools with :func:`~speech_diarization_tpu_torch.utils.blas.
single_blas_thread`, ``--reps`` times each, and checks the two settings'
results equal to the bit.  Prints the host's cores and BLAS pools, one
JSON line a length, and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def _host() -> dict:
    import scipy
    import torch

    from speech_diarization_tpu_torch.utils import blas

    pools = blas._pools()
    with open("/proc/self/maps") as f:
        mapped = sorted({ln.split(maxsplit=5)[5].strip() for ln in f
                         if any(k in ln.lower() for k in ("blas", "lapack", "mkl", "omp"))})
    return {"card": _card(), "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)), "numpy": np.__version__,
            "scipy": scipy.__version__, "torch": torch.__version__,
            "torch_threads": torch.get_num_threads(),
            "openblas": blas._mapped_libraries(),
            "openblas_threads": [get() for get, _ in pools], "mapped": mapped}


def _time(fn, reps: int) -> tuple[list[float], list]:
    """-> (ms of each rep, results) at the default pools and at one thread,
    interleaved."""
    from speech_diarization_tpu_torch.utils.blas import single_blas_thread

    ms = {"pool": [], "one": []}
    out = {}
    for _ in range(reps):
        for tag in ("pool", "one"):
            t0 = time.perf_counter()
            if tag == "one":
                with single_blas_thread():
                    r = fn()
            else:
                r = fn()
            ms[tag].append(1e3 * (time.perf_counter() - t0))
            out[tag] = r
    return ms, out


def _same(a, b) -> bool:
    if hasattr(a, "segments"):
        a, b = a.segments, b.segments
    if hasattr(a, "starts"):
        return all(np.array_equal(getattr(a, k), getattr(b, k))
                   for k in ("starts", "ends", "spks"))
    return np.array_equal(np.asarray(a), np.asarray(b))


def sweep_length(pipe, seconds: float, seed: int, reps: int) -> dict:
    from speech_diarization_tpu_torch import cluster as cm
    from speech_diarization_tpu_torch.cluster.spectral import _SPLIT_MAX_CENT_COS
    from speech_diarization_tpu_torch.train.synthetic import make_conversation

    n_spk = 2 if seconds < 60 else (3 if seconds < 600 else 4)
    wave, _ = make_conversation(np.random.default_rng(seed + int(seconds)), seconds,
                                n_speakers=n_spk, sr=16000)
    res = pipe(wave.astype(np.float32), collect_diagnostics=True)
    d = res.diagnostics
    cfg = pipe.cfg
    embs = np.asarray(d["window_embeddings"])
    starts = np.asarray(d["window_starts_s"])
    seg_embs = np.asarray(d["segment_embeddings"])
    segs = d["stage_clustered"]
    labels = pipe._cluster(seg_embs)
    merged = labels.copy()
    if labels.max() >= 1:
        merged[merged == 1] = 0
        merged[merged > 1] -= 1
    thr = cfg.cluster.refine_sub_cos or getattr(pipe.encoder, "refine_sub_cos",
                                                None) or _SPLIT_MAX_CENT_COS

    def refine(lab):
        return lambda: cm.refine_labels_by_windows(
            lab, segs, embs, starts, cfg.reseg.win_s, cfg.cluster.max_speakers,
            sub_cos_thr=thr, seg_embs=seg_embs)

    runs = {
        "spectral_cluster": lambda: cm.spectral_cluster(
            seg_embs, min_speakers=cfg.cluster.min_speakers,
            max_speakers=cfg.cluster.max_speakers),
        "refine": refine(labels),
        "refine_merged_pair": refine(merged),
        "segments_from_grid": lambda: pipe._segments_from_grid(
            res.vad_segments, d["vad_probs"], embs, starts, len(wave) / 16000),
    }
    row = {"seconds": seconds, "speakers": n_spk, "windows": int(embs.shape[0]),
           "segments": int(len(segs.starts)), "clusters": int(labels.max()) + 1}
    for name, fn in runs.items():
        ms, out = _time(fn, reps)
        row[name] = {"pool_ms": statistics.median(ms["pool"]),
                     "one_ms": statistics.median(ms["one"]),
                     "pool_all": ms["pool"], "one_all": ms["one"],
                     "equal": _same(out["pool"], out["one"])}
        if name.startswith("refine"):
            row[name]["clusters_out"] = int(np.max(out["one"])) + 1
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lengths", default="35,117,260,600,1800")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true", help="the pipeline on the CPU")
    ap.add_argument("--out", required=True, help="the report, JSON")
    args = ap.parse_args(argv)
    cache = ROOT / "perfbench" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))
    report = {"host": _host(), "lengths": []}
    print(json.dumps(report["host"]), flush=True)
    import torch

    from perfbench.harness.spec import resolve
    from perfbench.harness.systems import build

    device = "cpu" if args.cpu or not torch.cuda.is_available() else None
    system = build(resolve("default.calls").config, args.seed, device=device)
    pipe = system.program
    with torch.inference_mode():
        for s in (float(x) for x in args.lengths.split(",") if x):
            row = sweep_length(pipe, s, args.seed, args.reps)
            report["lengths"].append(row)
            print(json.dumps({k: ({kk: vv for kk, vv in v.items() if not kk.endswith("_all")}
                                  if isinstance(v, dict) else v) for k, v in row.items()}),
                  flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

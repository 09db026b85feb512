"""Where the port's host waits on the card, and where its host time goes, by
the port's own spans (``utils/logging.py``: the recorder behind
``stage_timer``).

    python3 scripts/torch_span_audit.py --cells default.calls,default.noisy \\
        --seed 7 --out audit.json [--overhead 20 --pairs 2]

For each benchmark cell (its configuration and traffic from ``BENCHMARK.json``,
built as ``perfbench/harness`` builds them): one warm pass over the cell's
pool; one pass under ``torch.cuda.set_sync_debug_mode("warn")`` with the
recorder on, every synchronising operation named by its innermost frame in
the port and the stages open around it, and marked whether a ``wait=True``
stage holds it; one pass with the recorder alone, giving each stage's self
time (its wall less its children's) and counters per file, each device
stage's CUDA-event time, the waits per file, and the BLAS threads each
``cluster`` span counted (``blas_threads``: 1 under the host tail's
guard), and, in a cell whose front-end is the demix-dialog separator, each
``demix.*`` stage's row (parent, calls, wall, self and device time,
counters) per file.  ``--overhead S`` then runs the cell's benchmark window
(``perfbench/harness/runner.run_cell``, S seconds, no profiler) with the
recorder off and on in turns (off, on, on, off), ``--pairs`` times: the
recorder's cost on ``rtf`` and ``file_p95_s``.
Also checks, once, where ``torch.profiler`` puts the stages'
``record_function`` ranges.  Needs a CUDA card; prints one JSON line a
part and writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import warnings
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = str(ROOT / "speech_diarization_tpu_torch")


def _port_frame(stack) -> str:
    for fr in reversed(stack):
        if fr.filename.startswith(PORT_DIR) and not fr.filename.endswith("logging.py"):
            return f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno} {fr.name}"
    return "outside the port"


def sync_pass(pipe, pool, lg) -> dict:
    """Every pool file once under the sync debug mode: the synchronising
    operations by place and the stages around them, per file."""
    import torch

    sites: Counter = Counter()
    stages_of: dict[str, set] = defaultdict(set)
    unheld: Counter = Counter()
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return shown(message, category, filename, lineno, file, line)
        site = _port_frame(traceback.extract_stack())
        stack = lg.RECORDER._stack() if lg.RECORDER is not None else []
        sites[site] += 1
        stages_of[site].add(" > ".join(s.name for s in stack) or "(no stage)")
        if not any(s.wait for s in stack):
            unheld[site] += 1

    with warnings.catch_warnings(), lg.recording() as rec:
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for d in pool:
                pipe(d.wave)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
        torch.cuda.synchronize()
    n = len(pool)
    return {"files": n,
            "syncs_per_file": {k: v / n for k, v in sites.most_common()},
            "stages": {k: sorted(v) for k, v in stages_of.items()},
            "not_in_a_wait_stage_per_file": {k: v / n for k, v in unheld.items()},
            "wait_stages_per_file": _waits_per_file(rec)}


def _waits_per_file(rec) -> dict:
    by_id = rec.by_id()

    def inside_wait(s):
        p = s.parent
        while p is not None:
            if by_id[p].wait:
                return True
            p = by_id[p].parent
        return False

    files = {s.file for s in rec.spans if s.file is not None}
    waits = Counter(s.name for s in rec.spans
                    if s.wait and s.file is not None and not inside_wait(s))
    return {"files": len(files), "by_name": {k: v / max(len(files), 1)
                                             for k, v in waits.items()},
            "total": sum(waits.values()) / max(len(files), 1)}


def timed_pass(pipe, pool, lg) -> dict:
    """Every pool file once with the recorder on: self time, wall, device
    time and counters of each stage, per file."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with lg.recording() as rec:
        for d in pool:
            pipe(d.wave)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec.resolve()
    n = len({s.file for s in rec.spans if s.file is not None})
    child_ms: dict[int, float] = defaultdict(float)
    for s in rec.spans:
        if s.parent is not None:
            child_ms[s.parent] += s.wall_ms
    by_id = rec.by_id()
    out: dict[str, dict] = {}
    for s in rec.spans:
        parent = by_id[s.parent].name if s.parent is not None else None
        e = out.setdefault(s.name, {"parent": parent, "n": 0, "wall_ms": 0.0,
                                    "self_ms": 0.0, "device_ms": 0.0,
                                    "counts": Counter()})
        e["n"] += 1
        e["wall_ms"] += s.wall_ms
        e["self_ms"] += s.wall_ms - child_ms[s.id]
        e["device_ms"] += s.device_ms or 0.0
        e["counts"].update(s.counts or {})
    per_file = {k: {"parent": v["parent"], "calls": v["n"] / n,
                    "wall_ms": v["wall_ms"] / n, "self_ms": v["self_ms"] / n,
                    "device_ms": v["device_ms"] / n,
                    "counts": {c: x / n for c, x in v["counts"].items()}}
                for k, v in out.items()}
    audio_s = sum(d.seconds for d in pool)
    # the BLAS pool each file's host tail ran on: {threads: cluster spans}
    blas = Counter(str((s.counts or {}).get("blas_threads")) for s in rec.spans
                   if s.name == "cluster")
    return {"files": n, "audio_s": audio_s, "wall_s": wall, "per_file": per_file,
            "waits": _waits_per_file(rec), "blas_threads": dict(blas)}


def profiler_probe(lg) -> dict:
    """Where the stages' ranges land: with CUDA activity alone (as the
    benchmark's trace) and with CPU and CUDA (as ``Profiler.trace``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    log = lg.get_logger("span_audit")
    x = torch.randn(2048, 2048, device="cuda")
    out = {}
    for tag, acts in (("cuda", [ProfilerActivity.CUDA]),
                      ("cpu+cuda", [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof, lg.recording() as rec:
            enabled = torch.autograd._profiler_enabled()
            with lg.stage_timer(log, "probe.outer"):
                with lg.stage_timer(log, "probe.inner"):
                    (x @ x).sum()
            torch.cuda.synchronize()
        evs = prof.profiler.kineto_results.events()
        named = [(str(e.device_type()), e.name(), e.start_ns(),
                  e.start_ns() + e.duration_ns())
                 for e in evs if e.name().startswith("probe.")]
        sp = {s.name: (s.start_ns, s.end_ns) for s in rec.spans}
        out[tag] = {"enabled_in_block": enabled,
                    "ranges": [{"device": d, "name": n,
                                "start_minus_span_us": (a - sp[n][0]) / 1e3,
                                "end_minus_span_us": (b - sp[n][1]) / 1e3}
                               for d, n, a, b in named],
                    "device_kinds": sorted({str(e.device_type()) for e in evs})}
    return out


def overhead(cell, seed: int, seconds: float, pairs: int, lg) -> list[dict]:
    from perfbench.harness import runner

    rows = []
    for p in range(pairs):
        for on in (False, True, True, False):
            if on:
                with lg.recording():
                    r = runner.run_cell(cell, seed + p, seconds)
            else:
                r = runner.run_cell(cell, seed + p, seconds)
            rows.append({"recording": on, "seed": seed + p, "correct": r["correct"],
                         "n_done": r["n_done"], **r["metrics"]})
            print(json.dumps({"overhead": cell.name, **rows[-1]}), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default="default.calls,eres2netv2.calls,default.noisy")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--overhead", type=float, default=0.0,
                    help="seconds of each benchmark window; 0: none")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--out", required=True, help="the report, JSON")
    args = ap.parse_args(argv)
    cache = ROOT / "perfbench" / ".cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_span_audit: needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench.harness import traffic
    from perfbench.harness.spec import resolve
    from perfbench.harness.systems import build
    from speech_diarization_tpu_torch.utils import logging as lg

    report = {"card": torch.cuda.get_device_name(0), "profiler": profiler_probe(lg)}
    print(json.dumps({"profiler": report["profiler"]}), flush=True)
    for name in [c for c in args.cells.split(",") if c]:
        cell = resolve(name)
        system = build(cell.config, args.seed)
        pool = traffic.make_pool(cell.traffic, args.seed, workers=2)
        pipe = system.program
        for d in pool:                                  # warm every shape
            pipe(d.wave)
        torch.cuda.synchronize()
        row = {"cell": name, "sync": sync_pass(pipe, pool, lg),
               "timed": timed_pass(pipe, pool, lg)}
        del system, pipe
        torch.cuda.empty_cache()
        if args.overhead > 0:
            row["overhead"] = overhead(cell, args.seed, args.overhead, args.pairs, lg)
        report[name] = row
        demix = {k: v for k, v in row["timed"]["per_file"].items() if k.startswith("demix.")}
        print(json.dumps({"cell": name, "sync": row["sync"],
                          "blas_threads": row["timed"]["blas_threads"],
                          **({"demix_per_file": demix} if demix else {})}), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Runs of cells one after another, each a fresh ``run.py`` process, and the
spread of each metric: what sets the bounds of ``BENCHMARK.json``.

    python3 perfbench/series.py --cells default.calls --seeds 11,12,13,14,15,16 \\
        --sets 2 --seconds 30 --trace 0 --out chiprun_out/series

Each set runs every seed once, in the same order, so two sets hold the same
seeds.  Writes one JSON line a run to ``<out>/runs.jsonl`` (the result line,
exit code, wall, the end of standard error) and prints, for each cell, set
and metric, the median and the spread: the distance between the first and
third quartiles of ``statistics.quantiles(values, n=4)`` over the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def run_one(cell: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"cell": cell, "seed": seed, "trace": trace, "rc": p.returncode,
            "wall_s": wall, "result": result,
            "info": lines[-2] if len(lines) > 1 else None,
            "stderr_tail": p.stderr[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    with open(out / "runs.jsonl", "a") as f:
        for cell in args.cells.split(","):
            for s in range(args.sets):
                for seed in seeds:
                    r = run_one(cell, seed, args.seconds, args.trace)
                    r["set"] = s
                    rows.append(r)
                    f.write(json.dumps(r) + "\n")
                    f.flush()
                    res = r["result"] or {}
                    print(json.dumps({"cell": cell, "set": s, "seed": seed, "rc": r["rc"],
                                      "wall_s": round(r["wall_s"], 3),
                                      "correct": res.get("correct"),
                                      "metrics": {k: v["value"] for k, v in
                                                  res.get("metrics", {}).items()},
                                      "check": {k: v["value"] for k, v in
                                                res.get("check", {}).items()}}),
                          flush=True)
    for cell in args.cells.split(","):
        for s in range(args.sets):
            got = [r["result"] for r in rows if r["cell"] == cell and r["set"] == s
                   and r["result"]]
            names = sorted({k for g in got for k in g["metrics"]})
            for name in names:
                vals = [g["metrics"][name]["value"] for g in got if name in g["metrics"]]
                if len(vals) >= 2:
                    print(f"{cell} set {s} {name}: n {len(vals)} median "
                          f"{statistics.median(vals)!r} spread {spread(vals)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The two readings each limit of ``limits/<cell>.json`` is set from, in one
process on the card.

    python3 perfbench/readings.py --cell default.calls --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 --seconds 5 --out chiprun_out/readings.jsonl

For each seed, a run of the cell at its own load (a short window that
completes the files the check samples) and the check's numbers: their
largest over the seeds is the lower reading.  For each control seed, the
same with the control in the program's place: the reference one precision
step below the configuration's (``harness/precision.py``); their smallest
is the upper reading.  Runs here are judged against no limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seconds", type=float, default=None)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import runner
    from perfbench.harness.spec import resolve

    cell = resolve(args.cell)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    plan = [(int(s), False) for s in args.seeds.split(",") if s]
    plan += [(int(s), True) for s in args.control_seeds.split(",") if s]
    with open(out, "a") as f:
        for seed, control in plan:
            secs = args.control_seconds if control and args.control_seconds else args.seconds
            r = runner.run_cell(cell, seed, secs, control=control, limits={})
            row = {"cell": args.cell, "seed": seed, "control": control,
                   "n_done": r["n_done"], "failed": r["failed"],
                   "errors": r["errors"], "numbers": r["numbers"]}
            f.write(json.dumps(row) + "\n")
            f.flush()
            print(json.dumps(row), flush=True)
            for k, v in r["numbers"].items():
                if control:
                    upper[k] = min(upper.get(k, float("inf")), v)
                else:
                    lower[k] = max(lower.get(k, 0.0), v)
    print(json.dumps({"cell": args.cell, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

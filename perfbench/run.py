"""The benchmark of the PyTorch/CUDA port (``speech_diarization_tpu_torch``).

One run of one cell of ``BENCHMARK.json``::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for.  Set-up (imports, kernel libraries from the checkout's build cache,
weights, the seeded pool of files, warm-up of the cell's shapes) is timed
as ``setup_s``; then files run closed loop for ``--seconds``; then the
check compares a seeded sample of the completed files with the reference.
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the profiler's busy and window seconds
and a breakdown.  The last line of standard output is the result; the last
lines of standard error are the numbers the check compared, each beside its
limit.  Exits non-zero, printing no result, without enough CUDA cards, when
the run loaded JAX or the JAX package, or when anything fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))

    import torch

    from perfbench.harness import runner
    from perfbench.harness.spec import load_benchmark, resolve

    bench = load_benchmark()
    cell = resolve(args.workload, bench)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = runner.run_cell(cell, args.seed, args.seconds, trace=bool(args.trace))
    bad = runner.forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": units[m["name"]]}
               for m in wanted if m["name"] in out["metrics"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["check"] = out["check"]
    print(json.dumps({"files_completed": out["n_done"], "der_mean": out["der_mean"],
                      "errors": out["errors"], "setup_phases": out["setup_phases"]}))
    for name, v in out["check"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

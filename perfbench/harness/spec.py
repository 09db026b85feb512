"""Resolve a cell of ``BENCHMARK.json`` to its files, by name alone.

A cell names a configuration and a traffic mix; each is a JSON file of its
own (``configs/<config>.json``, ``traffic/<traffic>.json``), each
per-layer metric a reader of its own (``metrics/<metric>.py``), and each
model kind a configuration's block names a builder of its own
(``kinds/<kind>.py``).  Adding a configuration, a mix, a metric, a model kind
or a cell is adding files and entries: no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]          # perfbench/
ROOT = BENCH.parent                                  # the checkout


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]      # the cell's end-to-end metrics
    per_layer: list[dict]       # the cell's per-layer metrics
    chips: int


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(cell_name: str, bench: dict | None = None,
            root: Path = ROOT) -> Cell:
    """The cell's configuration and traffic files, read, and the metrics
    that apply to it; raises ``KeyError`` for an unknown cell and
    ``FileNotFoundError`` for a missing file."""
    bench = load_benchmark(root) if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json")
    w = cells[cell_name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = cfgs[w["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    config.setdefault("name", cfg_entry["name"])
    with open(traffic_path(w["traffic"], root)) as f:
        traffic = json.load(f)
    traffic.setdefault("name", w["traffic"])
    return Cell(
        name=cell_name, config=config, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, cell_name)],
        chips=int(w["chips"]))


def traffic_path(name: str, root: Path = ROOT) -> Path:
    return root / "perfbench" / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = ROOT) -> Path:
    return root / "perfbench" / "metrics" / f"{name}.py"


def load_reader(name: str, root: Path = ROOT):
    """The reader module of a per-layer metric: ``read(ctx)`` returns the
    number or None (nothing to read); an optional ``install(ctx)`` puts its
    wrappers on the system before the traced window."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_path(name: str, root: Path = ROOT) -> Path:
    return root / "perfbench" / "kinds" / f"{name}.py"


def load_kind(name: str, root: Path = ROOT):
    """The module of a model kind, named by a configuration block's
    ``kind``: ``build(block, side)``, ``rates(block, probe)`` and
    ``terms(rates, geo)`` (``perfbench/README.md``, "Model kinds").  Raises
    ``FileNotFoundError`` naming the path it looked for."""
    path = kind_path(name, root)
    if not path.is_file():
        raise FileNotFoundError(f"no model kind {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.kinds.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

"""Every cell of BENCHMARK.json resolves to its files by name, and a cell
added only as new files resolves too; the file keeps the contract's shape."""
from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    c = spec.resolve(cell, BENCH)
    assert c.config["loader"] == "diarizer"
    assert c.traffic["generator"] in ("conversation", "heldout")
    assert (ROOT / "perfbench" / "limits" / f"{cell}.json").exists()
    for m in c.per_layer:
        mod = spec.load_reader(m["name"])
        assert callable(mod.read)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).exists()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_cell_as_new_files_only(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries, with no file of the harness edited."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "perfbench/configs/diarizer_default.json").read_text())
    cfg["pipeline"]["cluster"]["max_speakers"] = 4
    (tmp_path / "perfbench/configs/diarizer_max4.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench/traffic/short.json").write_text(json.dumps({
        "generator": "conversation", "pool": 2, "lengths_s": {"fixed": [20, 30]},
        "speakers": [2], "entry": "call", "check_files": 1}))
    (tmp_path / "perfbench/metrics/files_per_min.py").write_text(
        "def read(ctx):\n    return len(ctx.files) / (ctx.window_s / 60.0)\n")
    (tmp_path / "perfbench/limits/max4.short.json").write_text(json.dumps(
        {"limits": {"tail_mismatch": 0}}))
    bench["configs"].append({"name": "diarizer_max4", "source": "https://example.org/x",
                             "file": "perfbench/configs/diarizer_max4.json",
                             "reduced": [], "why": "a throwaway"})
    bench["workloads"].append({"name": "max4.short", "config": "diarizer_max4",
                               "traffic": "short", "chips": 1, "why": "a throwaway"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("max4.short")
    bench["per_layer"].append({"name": "files_per_min", "unit": "1/min", "better": "higher",
                               "source": "host_clock", "layer": "whole step",
                               "moves": "rtf", "workloads": ["max4.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.resolve("max4.short", root=tmp_path)
    assert c.config["pipeline"]["cluster"]["max_speakers"] == 4
    assert c.traffic["pool"] == 2
    assert [m["name"] for m in c.per_layer] == ["files_per_min"]
    mod = spec.load_reader("files_per_min", root=tmp_path)

    class Ctx:
        files = [1, 2, 3]
        window_s = 30.0

    assert mod.read(Ctx()) == 6.0
    old = spec.resolve("default.calls", root=tmp_path)
    assert old.traffic == spec.resolve("default.calls").traffic


@pytest.mark.parametrize("config", sorted(p.stem for p in (ROOT / "perfbench/configs").glob("*.json")))
def test_stated_widths_are_the_checkpoints(config):
    """Every ``net`` block that names a checkpoint states its meta's widths,
    and a changed width is refused."""
    from perfbench.harness.systems import check_widths

    cfg = json.loads((ROOT / "perfbench/configs" / f"{config}.json").read_text())
    check_widths(cfg)
    block = cfg["vad"]["net"]
    block["channels"] = block["channels"] + 1
    with pytest.raises(ValueError, match="vad.net"):
        check_widths(cfg)

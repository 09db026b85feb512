"""The import guard: no module of the benchmark imports JAX or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference imports the port neither."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "speech_diarization_tpu"}
PORT = "speech_diarization_tpu_torch"
FILES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


def _tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def _in_reference(path: Path) -> bool:
    return (BENCH / "reference") in path.parents


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not _tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if _in_reference(p)],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_no_port(path):
    assert PORT not in _tops(path)


def test_the_top_level_names_are_compared_whole():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("speech_diarization_tpu")


def test_reference_loads_nothing_forbidden():
    """Importing every reference module in a fresh process loads neither
    JAX, the JAX package nor the port."""
    mods = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  for p in FILES if _in_reference(p) and p.name != "__init__.py")
    code = ("import sys, importlib\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted({n.split('.')[0] for n in sys.modules} & "
            f"set({sorted(FORBIDDEN | {PORT})!r}))\n"
            "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip()
    assert out == ""

"""Model kinds (``perfbench/kinds/<kind>.py``): the two kinds of the
committed configurations build, on both sides, what the harness built before
kinds existed, and count the same operations to the bit; a configuration of
a new encoder kind and a new enhancer kind enters as new files and entries
only, and runs through the program and the reference.

The parent's recipe (``harness/systems.py::Diarizer._build`` at the commit
before kinds, 238c2bb's harness): ``ecapa_npz`` is the port's
``models.port.load_speaker_encoder(weights, dtype=<precision.encoder_trunk>)``
on the program's side, the reference's at float32 (at the trunk's dtype for
the control); ``eres2netv2_seeded`` is ``ERes2NetV2Model(ERes2NetV2(**net))``
of each side's module, loaded with ``weights.seeded_state_dict_on_device``
of the net's manifest, the run's seed and the program's device; the VAD is
each side's ``load_vad(weights)``; GTCRN is built by each pipeline from
``enhance.backend`` and ``enhance.weights``.

``FLOPS`` holds ``flops.file_flops`` as that harness gave it, as
``float.hex``: on the CPU, for each configuration, with a stand-in system
holding only the configuration, at 560,000, 1,876,543 and 4,160,000 samples,
on the streamed route (``{"route": "streamed", "enhancer": None,
"overlap_hard": <an array>}``) and on the whole-file path with the enhancer
engaged (``{"route": "legacy", "enhancer": "gtcrn"}``).
"""
from __future__ import annotations

import hashlib
import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import flops, spec, systems  # noqa: E402
from perfbench.harness.weights import seeded_state_dict_on_device  # noqa: E402

SEED = 2 ** 31 + 303
LENGTHS = (560000, 1876543, 4160000)
ROUTES = {"streamed": {"route": "streamed", "enhancer": None, "overlap_hard": np.zeros(1)},
          "whole_enhanced": {"route": "legacy", "enhancer": "gtcrn"}}
FLOPS = {
    ("diarizer_default", "streamed"): (
        "0x1.25d37678d9c86p+35", "0x1.fea1bd6d1efe9p+36", "0x1.1d0211d658efep+38"),
    ("diarizer_default", "whole_enhanced"): (
        "0x1.6c4e0eb3f390dp+34", "0x1.34da07c2cee60p+36", "0x1.574603c599dfdp+37"),
    ("diarizer_eres2netv2", "streamed"): (
        "0x1.ea82f71254800p+41", "0x1.ab8ccf38b5a00p+43", "0x1.de1f4bfccdd00p+44"),
    ("diarizer_eres2netv2", "whole_enhanced"): (
        "0x1.e89a38ddbc800p+41", "0x1.a9d6080f475fdp+43", "0x1.dc32c6a166d00p+44"),
}


def _config(name: str) -> dict:
    return json.loads((ROOT / "perfbench/configs" / f"{name}.json").read_text())


def _bits(module: torch.nn.Module) -> dict[str, tuple]:
    """Each state_dict entry's dtype, shape and bytes."""
    return {k: (v.dtype, tuple(v.shape),
                v.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
            for k, v in module.state_dict().items()}


def _parent_encoder(config: dict, program: bool, stated: bool):
    pkg = "speech_diarization_tpu_torch" if program else "perfbench.reference"
    e = config["encoder"]
    if e["kind"] == "ecapa_npz":
        port = importlib.import_module(f"{pkg}.models.port")
        trunk = config["precision"]["encoder_trunk"]
        dtype = torch.bfloat16 if (program or stated) and trunk == "bfloat16" else None
        return port.load_speaker_encoder(str(ROOT / e["weights"]), dtype=dtype)
    mod = importlib.import_module(f"{pkg}.models.eres2netv2")
    model = mod.ERes2NetV2Model(mod.ERes2NetV2(**e["net"]))
    manifest = {k: tuple(v.shape) for k, v in model.net.state_dict().items()}
    model.net.load_state_dict(seeded_state_dict_on_device(manifest, SEED, "cpu"))
    return model


@pytest.mark.parametrize("name", ["diarizer_default", "diarizer_eres2netv2"])
def test_kinds_build_the_parents_modules(name):
    """Program, reference and control: the encoder, the VAD and the
    pipeline-built GTCRN of the same classes as the parent's, with state
    dicts equal to the bit."""
    config = _config(name)
    system = systems.build(config, SEED, "cpu")
    for pipe, program, stated in ((system.program, True, False),
                                  (system.reference(), False, False),
                                  (system.reference(stated=True), False, True)):
        want = _parent_encoder(config, program, stated)
        assert type(pipe.encoder) is type(want)
        assert _bits(pipe.encoder) == _bits(want)
        pkg = "speech_diarization_tpu_torch" if program else "perfbench.reference"
        port = importlib.import_module(f"{pkg}.models.port")
        vad = port.load_vad(str(ROOT / config["vad"]["weights"]))
        assert type(pipe.vad) is type(vad) and _bits(pipe.vad) == _bits(vad)
        gtcrn = port.load_gtcrn(str(ROOT / config["enhancer"]["weights"]))
        assert type(pipe.enhance_fn.net) is type(gtcrn)
        assert _bits(pipe.enhance_fn.net) == _bits(gtcrn)
        assert type(pipe).__module__ == f"{pkg}.pipelines.diarize"


@pytest.fixture(scope="module")
def stand_ins():
    """One stand-in system a configuration, so the rates are counted once."""
    return {name: SimpleNamespace(config=_config(name))
            for name in ("diarizer_default", "diarizer_eres2netv2")}


@pytest.mark.parametrize("name,route", sorted(FLOPS))
def test_file_flops_equal_the_parents(stand_ins, name, route):
    result = SimpleNamespace(diagnostics=ROUTES[route])
    got = [flops.file_flops(stand_ins[name], n, result) for n in LENGTHS]
    assert got == [float.fromhex(h) for h in FLOPS[name, route]]


def test_unknown_kind_names_the_path():
    config = _config("diarizer_default")
    config["encoder"]["kind"] = "no_such_kind"
    path = spec.kind_path("no_such_kind")
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        systems.build(config, SEED, "cpu")
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        flops.file_flops(SimpleNamespace(config=config), LENGTHS[0],
                         SimpleNamespace(diagnostics=ROUTES["streamed"]))


# -- a configuration of two new kinds, as new files only ----------------------

GTCRN_KIND = '''"""GTCRN of a shipped .npz, built by this kind and handed to the pipeline
as enhance_fn on both sides."""
import torch

from perfbench.harness.flops import SR


def build(block, side):
    enhance = side.module("pipelines.enhance")
    e = side.cfg.enhance
    return enhance.make_enhance_fn("gtcrn", weights=side.path(block["weights"]),
                                   device=side.device, chunk_s=e.chunk_s,
                                   overlap_s=e.overlap_s)


def rates(block, probe):
    from perfbench.reference.models import port
    from perfbench.reference.pipelines.enhance import GtcrnEnhancer

    gt = GtcrnEnhancer(port.load_gtcrn(probe.path(block["weights"])))
    wav = 0.1 * torch.randn(1, SR, generator=probe.g)
    return {"ps": probe.count(lambda: gt.forward(wav), gt.net) / SR}


def terms(r, geo):
    return [geo.n_samples * r["ps"]]
'''

SMALL_NET = {"n_mels": 80, "m_channels": 8, "base_width": 8, "scale": 2, "expansion": 2,
             "num_blocks": [1, 1, 1, 1], "emb_dim": 32}
NEW_LIMITS = {"vad_gap": 0.003, "energy_gap": 0.01, "fbank_gap": 0.03, "enc_step_gap": 0.01,
              "stitch_mismatch": 0, "enh_gap": 0.0003, "tail_mismatch": 0}


def add_new_kinds(root: Path) -> None:
    """Into the checkout at ``root``: an encoder kind (ERes2NetV2 under
    another name, at small widths), an enhancer kind (GTCRN from
    ``gtcrn_synthetic.npz``, handed over as ``enhance_fn``), a configuration
    of both, its limits (those of ``eres2netv2.calls`` and
    ``default.noisy`` for the layers it shares with them) and the cell
    ``newkinds.noisy``: new files and entries of ``BENCHMARK.json`` only."""
    b = root / "perfbench"
    shutil.copyfile(b / "kinds/eres2netv2_seeded.py", b / "kinds/eres2netv2_small.py")
    (b / "kinds/gtcrn_npz.py").write_text(GTCRN_KIND)
    cfg = json.loads((b / "configs/diarizer_eres2netv2.json").read_text())
    cfg.update(name="diarizer_newkinds",
               encoder={"kind": "eres2netv2_small", "net": SMALL_NET},
               enhancer={"kind": "gtcrn_npz", "backend": "gtcrn",
                         "weights": "weights/gtcrn_synthetic.npz"})
    (b / "configs/diarizer_newkinds.json").write_text(json.dumps(cfg, indent=1))
    (b / "limits/newkinds.noisy.json").write_text(json.dumps({"limits": NEW_LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "diarizer_newkinds", "source": "https://example.org/x",
                             "file": "perfbench/configs/diarizer_newkinds.json",
                             "reduced": [], "why": "two new model kinds"})
    bench["workloads"].append({"name": "newkinds.noisy", "config": "diarizer_newkinds",
                               "traffic": "noisy", "chips": 1, "why": "two new model kinds"})
    for m in bench["end_to_end"]:
        if "default.noisy" in m.get("workloads", ()):
            m["workloads"].append("newkinds.noisy")
    for m in bench["per_layer"]:
        if {"eres2netv2.calls", "default.noisy"} & set(m["workloads"]) \
                and m["name"] != "asp_grid_stats_roofline":
            m["workloads"].append("newkinds.noisy")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


RUN = """
import json, math, sys
from types import SimpleNamespace
sys.path[:0] = [{copy!r}, {root!r}]
from perfbench.harness import flops, runner, spec
from pathlib import Path
assert spec.ROOT == Path({copy!r}).resolve(), spec.ROOT
cell = spec.resolve("newkinds.noisy")
cell.traffic = dict(cell.traffic, pool=1, lengths_s={{"fixed": [15.0]}}, check_files=1)
out = runner.run_cell(cell, {seed}, 1.0, device="cpu", pool_workers=1)
n = 15 * 16000
res = SimpleNamespace(diagnostics={{"route": "legacy", "enhancer": "gtcrn"}})
total = flops.file_flops(SimpleNamespace(config=cell.config), n, res)
bare = dict(cell.config)
del bare["enhancer"]
base = flops.file_flops(SimpleNamespace(config=bare), n, res)
print(json.dumps({{"correct": out["correct"], "numbers": out["numbers"],
                  "failed": out["failed"], "errors": out["errors"],
                  "enhancer_flops": total - base}}))
"""


def _digest(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*")) if p.is_file()}


def test_new_kind_as_new_files_only(tmp_path):
    """In a copy of the checkout's benchmark, a configuration whose encoder
    and enhancer are of new kinds, and its cell, added as new files and
    entries: the copy's own harness builds it on the CPU and runs a 15 s
    noisy draw through the program and the reference; the check reads the
    windowed grid's features and the enhancer's waveform, the tail to the
    bit, and the operation count holds the enhancer's term."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copyfile(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "weights").symlink_to(ROOT / "weights")
    before = _digest(tmp_path)
    old_bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    add_new_kinds(tmp_path)
    code = RUN.format(copy=str(tmp_path), root=str(ROOT), seed=SEED)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=300,
                          env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    nums = out["numbers"]
    assert math.isfinite(nums["enh_gap"]) and math.isfinite(nums["fbank_gap"]), nums
    assert nums["tail_mismatch"] == 0 and nums["stitch_mismatch"] == 0, nums
    assert out["correct"] and out["failed"] == 0, out
    assert out["enhancer_flops"] > 0
    after = _digest(tmp_path)
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == [
        "perfbench/configs/diarizer_newkinds.json", "perfbench/kinds/eres2netv2_small.py",
        "perfbench/kinds/gtcrn_npz.py", "perfbench/limits/newkinds.noisy.json"]
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert bench["configs"][:len(old_bench["configs"])] == old_bench["configs"]
    assert bench["workloads"][:len(old_bench["workloads"])] == old_bench["workloads"]

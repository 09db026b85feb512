"""Guards on the PyTorch port: it imports neither JAX nor the JAX package,
its kernel wrappers take the plain version only for CPU tensors, and its
kernel sources and launch counters are in place."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "speech_diarization_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "scripts" / "torch_profile_diarize.py",
                                        ROOT / "scripts" / "torch_kernel_check.py",
                                        ROOT / "scripts" / "torch_bench.py",
                                        ROOT / "scripts" / "torch_eval_heldout.py",
                                        ROOT / "scripts" / "torch_train_mc.py",
                                        ROOT / "scripts" / "torch_train_grad_noise.py",
                                        ROOT / "scripts" / "torch_mesh_step_probe.py",
                                        ROOT / "scripts" / "torch_mesh_cards.py"] + [
    ROOT / "scripts" / f"torch_{name}.py" for name in (
        "eval_rttm", "eval_synthetic", "eval_tail", "calibrate_bisect",
        "eval_vad", "eval_overlap_det", "eval_segmentation", "probe_encoder",
        "eval_enhancer", "eval_grid_backends")]


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_import(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "optax", "chex"), (path, mod)
        assert top != "speech_diarization_tpu", (path, mod)
    text = path.read_text()
    assert "import jax" not in text and "from jax" not in text


def test_the_port_needs_no_scikit_learn():
    """The card's machine has no scikit-learn: HDBSCAN is the port's own."""
    for path in SOURCES:
        assert not any(m.split(".")[0] == "sklearn" for m in _imports(path)), path


def test_the_port_imports_matplotlib_only_inside_functions():
    """The card's machine has no matplotlib: ``plot_diagnostics`` imports it
    when it is called, and no module of the port at import."""
    for path in SOURCES:
        tree = ast.parse(path.read_text())
        top = [a.name for n in tree.body if isinstance(n, ast.Import) for a in n.names]
        top += [n.module for n in tree.body
                if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(m.split(".")[0] == "matplotlib" for m in top), path


def test_port_imports_without_jax_in_a_fresh_process():
    code = ("import sys, importlib, pkgutil\n"
            "import speech_diarization_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'speech_diarization_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


@pytest.mark.parametrize("name", ["asp_grid.cu", "fused_fbank.cu"])
def test_kernel_sources_carry_their_note(name):
    text = (PORT / "csrc" / name).read_text()
    head = text[:text.index("#include")]
    assert "Replaces: speech_diarization_tpu/ops/pallas/" in head
    assert "What bounds it on the H100" in head
    assert "Design" in head


def test_k3_source_carries_its_note():
    """K3 replaces no Pallas kernel: its note names its JAX counterpart,
    why it was added, what bounds it and its design."""
    text = (PORT / "csrc" / "resample_poly.cu").read_text()
    head = text[:text.index("#include")]
    assert "Replaces no Pallas kernel" in head
    assert "dsp/resample.py::resample_poly_jax" in head
    assert "htdemucs.babble" in head
    assert "What bounds it on the H100: bytes" in head
    assert "Design" in head


def test_launch_counters_do_not_move_on_the_cpu():
    from speech_diarization_tpu_torch.dsp.mel import fused_log_mel
    from speech_diarization_tpu_torch.ops import kernels

    kernels.reset_launches()
    fused_log_mel(torch.randn(4000), n_mels=40)
    fused_log_mel(torch.randn(3, 4000), n_mels=40)
    assert kernels.LAUNCHES == {"asp_grid_stats": 0, "fused_log_mel": 0,
                                "resample_poly": 0}
    assert kernels.LAUNCH_FORMS == {}
    assert kernels.LAUNCH_SHAPES == {}


def test_launch_counts_by_name_form_and_shape(monkeypatch):
    """A launch is counted under its kernel, its form and its shape, and a
    refused one under none."""
    from types import SimpleNamespace

    from speech_diarization_tpu_torch.ops import kernels

    rc = [0]
    fake = SimpleNamespace(sdt_fused_log_mel=lambda *a: rc[0])
    monkeypatch.setattr(kernels, "library", lambda name: fake)
    kernels.reset_launches()
    kernels.launch("fused_log_mel", form="[T]", shape="[T] 80 mels")
    kernels.launch("fused_log_mel", form="[B, T]",
                   shape="[B, T] rows of 32000, 40 mels")
    kernels.launch("fused_log_mel", form="[T]", shape="[T] 40 mels")
    rc[0] = 1
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernels.launch("fused_log_mel", form="[T]", shape="[T] 40 mels")
    assert kernels.LAUNCHES == {"asp_grid_stats": 0, "fused_log_mel": 3,
                                "resample_poly": 0}
    assert kernels.LAUNCH_FORMS == {"fused_log_mel[T]": 2,
                                    "fused_log_mel[B, T]": 1}
    assert kernels.LAUNCH_SHAPES == {
        "fused_log_mel [T] 80 mels": 1, "fused_log_mel [T] 40 mels": 1,
        "fused_log_mel [B, T] rows of 32000, 40 mels": 1}
    kernels.reset_launches()


def test_build_directory_is_ignored_by_git():
    text = (ROOT / ".gitignore").read_text().split()
    assert "speech_diarization_tpu_torch/build/" in text


def test_kernel_entry_signatures_match_their_sources():
    """The ctypes argument list of each kernel has one entry per parameter
    of its C entry point."""
    import re

    from speech_diarization_tpu_torch.ops import kernels

    for name, (src, entry, argtypes) in kernels.KERNELS.items():
        text = (PORT / "csrc" / src).read_text()
        m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", text)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_batched_log_mel_on_a_cuda_tensor_never_takes_the_plain_version():
    """Without a card a CUDA tensor cannot exist here; the wrapper's only
    route to the plain version is the tensor's device being the CPU."""
    import inspect

    from speech_diarization_tpu_torch.dsp import mel

    src = inspect.getsource(mel.fused_log_mel)
    assert src.count("_log_mel_1d(") + src.count("log_mel_spectrogram(") == 1
    assert 'if y.device.type == "cpu":' in src
    assert not any(isinstance(n, ast.Try) for n in ast.walk(ast.parse(src)))

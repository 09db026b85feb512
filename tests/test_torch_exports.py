"""F22's guard: each subpackage of the port exports what the JAX package's
subpackage of the same name exports (its ``__all__``), but for named
JAX-only names, each with its reason; and importing the subpackages builds
no kernel and imports no matplotlib."""
from __future__ import annotations

import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

import speech_diarization_tpu as jax_pkg

ROOT = Path(__file__).resolve().parents[1]
_MODULE = "a functional JAX layer that is an nn.Module in the port"
# JAX-only names of each subpackage, and why the port has none
JAX_ONLY = {
    "dsp": {"resample_poly_jax": "its counterpart is dsp/resample.py::resample_poly"},
    "models": {
        "conv2d_torch": _MODULE + " (nn.Conv2d)",
        "conv_transpose2d_torch": _MODULE + " (nn.ConvTranspose2d)",
        "prelu": _MODULE + " (nn.PReLU)",
        "gru_sequence": _MODULE + " (nn.GRU, cuDNN on the card)",
        "GRUParams": "the JAX GRU's weights; nn.GRU holds them under torch's names",
        "gtcrn_init_params": "GTCRN() initialises itself; train/init.py draws "
                             "the JAX inits' distributions",
    },
}
SUBPACKAGES = sorted(m.name for m in pkgutil.iter_modules(jax_pkg.__path__)
                     if m.ispkg)
# the JAX subpackages that export an __all__ (native/ exports none)
EXPORTING = [s for s in SUBPACKAGES if hasattr(
    importlib.import_module(f"speech_diarization_tpu.{s}"), "__all__")]


def _all(mod_name: str) -> set[str] | None:
    try:
        mod = importlib.import_module(mod_name)
    except ModuleNotFoundError:
        return None
    return set(getattr(mod, "__all__", ()))


@pytest.mark.parametrize("sub", ["", *EXPORTING])
def test_port_exports_the_jax_names(sub):
    jax_names = _all("speech_diarization_tpu" + (f".{sub}" if sub else ""))
    port_names = _all("speech_diarization_tpu_torch" + (f".{sub}" if sub else ""))
    allowed = JAX_ONLY.get(sub, {})
    assert jax_names - (port_names or set()) == set(allowed), sub
    assert all(reason for reason in allowed.values())
    if port_names is not None:
        mod = importlib.import_module(
            "speech_diarization_tpu_torch" + (f".{sub}" if sub else ""))
        assert all(hasattr(mod, n) for n in port_names), sub


def test_pipelines_exports_the_pipeline_and_diarize():
    from speech_diarization_tpu_torch.pipelines import DiarizationPipeline, diarize

    mod = importlib.import_module("speech_diarization_tpu_torch.pipelines.diarize")
    assert DiarizationPipeline is mod.DiarizationPipeline
    assert diarize is mod.diarize


def test_top_level_exports_stems_and_sharding_configs():
    from speech_diarization_tpu_torch import ShardingConfig, StemsConfig, config

    assert StemsConfig is config.StemsConfig
    assert ShardingConfig is config.ShardingConfig
    assert config.config_from_dict({"stems": {"fade_ms": 5.0}}).stems.fade_ms == 5.0


def test_subpackages_import_no_kernel_build_and_no_matplotlib():
    code = ("import sys, importlib\n"
            f"for s in {SUBPACKAGES!r}:\n"
            "    try:\n"
            "        importlib.import_module('speech_diarization_tpu_torch.' + s)\n"
            "    except ModuleNotFoundError:\n"
            "        pass\n"
            "import speech_diarization_tpu_torch.webui\n"
            "from speech_diarization_tpu_torch.ops import kernels\n"
            "assert not kernels._LIBS, kernels._LIBS\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('matplotlib', 'jax', 'speech_diarization_tpu', 'triton')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)

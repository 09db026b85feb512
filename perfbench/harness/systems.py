"""Build the system under test and its reference from a configuration file.

A configuration's ``loader`` names a constructor here.  ``diarizer`` builds the
port's :class:`DiarizationPipeline` (``speech_diarization_tpu_torch``) and
the same pipeline from the frozen copy in ``perfbench/reference``, from the
same weights: a shipped checkpoint both read (``weights/*.npz``) or a
state_dict the benchmark draws on the device from the seed and hands to
both.  The program is imported only here and only when a system is built,
so the reference and the tests never load it by accident.
"""
from __future__ import annotations

import copy

import torch

from .spec import ROOT
from .weights import seeded_state_dict_on_device

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _path(p: str) -> str:
    return str(ROOT / p)


def pipeline_dict(config: dict) -> dict:
    """The pipeline settings of a configuration, with its checkpoints'
    paths resolved in the checkout."""
    d = copy.deepcopy(config.get("pipeline", {}))
    if "overlap_detector" in config:
        d.setdefault("overlap", {})["weights"] = _path(config["overlap_detector"]["weights"])
    if "enhancer" in config:
        e = config["enhancer"]
        d.setdefault("enhance", {}).update(backend=e["backend"], weights=_path(e["weights"]))
    return d


def check_widths(config: dict) -> None:
    """Every ``net`` block of a configuration that names a checkpoint must
    state that checkpoint's own architecture (its ``__meta__``'s ``net``),
    key for key: the widths the file documents are the widths that run."""
    from ..reference.models.port import load_params_meta

    for part, block in config.items():
        if not isinstance(block, dict) or "weights" not in block or "net" not in block:
            continue
        meta = load_params_meta(_path(block["weights"])).get("net", {})
        bad = {k: (v, meta.get(k)) for k, v in block["net"].items() if meta.get(k) != v}
        if bad:
            raise ValueError(f"{config.get('name', '?')}: {part}.net differs from "
                             f"{block['weights']}'s meta (stated, meta): {bad}")


class Diarizer:
    """The ``diarizer`` loader: ``program`` is the port's pipeline;
    :meth:`reference` builds the frozen copy's, at float32 (``stated=True``:
    at the configuration's own precision, the control's starting point)."""

    def __init__(self, config: dict, seed: int, device=None):
        self.config = config
        self.seed = int(seed)
        self.device = device
        self._enc_state = None
        check_widths(config)
        self.program = self._build(program=True)

    # -- weights -----------------------------------------------------------
    def _encoder(self, models_port, eres_mod, dtype):
        e = self.config["encoder"]
        if e["kind"] == "ecapa_npz":
            return models_port.load_speaker_encoder(_path(e["weights"]), dtype=dtype)
        if e["kind"] == "eres2netv2_seeded":
            model = eres_mod.ERes2NetV2Model(eres_mod.ERes2NetV2(**e["net"]))
            if self._enc_state is None:
                dev = "cuda" if self.device is None else self.device
                manifest = {k: tuple(v.shape) for k, v in model.net.state_dict().items()}
                self._enc_state = seeded_state_dict_on_device(manifest, self.seed, dev)
            model.net.load_state_dict({k: v.clone() for k, v in self._enc_state.items()})
            return model
        raise ValueError(f"unknown encoder kind {e['kind']!r}")

    def _build(self, program: bool, stated: bool = False):
        if program:
            from speech_diarization_tpu_torch.config import config_from_dict
            from speech_diarization_tpu_torch.models import eres2netv2 as eres_mod
            from speech_diarization_tpu_torch.models import port as models_port
            from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
        else:
            from ..reference.config import config_from_dict
            from ..reference.models import eres2netv2 as eres_mod
            from ..reference.models import port as models_port
            from ..reference.pipelines.diarize import DiarizationPipeline
        trunk = self.config.get("precision", {}).get("encoder_trunk", "float32")
        dtype = _DTYPES[trunk] if (program or stated) else None
        enc = self._encoder(models_port, eres_mod, dtype)
        vad = models_port.load_vad(_path(self.config["vad"]["weights"]))
        cfg = config_from_dict(pipeline_dict(self.config))
        return DiarizationPipeline(cfg, encoder=enc, vad=vad, device=self.device)

    def reference(self, stated: bool = False):
        return self._build(program=False, stated=stated)

    # -- the entries the window drives --------------------------------------
    def corpus(self, waves, pipe):
        """``corpus_diarize`` over ``waves`` with the given pipeline: ->
        (results by index, errors)."""
        if pipe is self.program:
            from speech_diarization_tpu_torch.pipelines.corpus import corpus_diarize
        else:
            return {i: pipe(w) for i, w in enumerate(waves)}, []
        rep = corpus_diarize(list(waves), pipeline_factory=lambda: pipe,
                             keep_results=True)
        return {e["index"]: e["result"] for e in rep.files}, rep.errors


LOADERS = {"diarizer": Diarizer}


def build(config: dict, seed: int, device=None):
    return LOADERS[config["loader"]](config, seed, device)


def stated_precision(config: dict) -> str:
    return config.get("precision", {}).get("stated", "float32")


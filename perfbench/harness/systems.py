"""Build the system under test and its reference from a configuration file.

A configuration's ``loader`` names a constructor here.  ``diarizer`` builds the
port's :class:`DiarizationPipeline` (``speech_diarization_tpu_torch``) and
the same pipeline from the frozen copy in ``perfbench/reference``, from the
same weights: a shipped checkpoint both read (``weights/*.npz``) or a
state_dict the benchmark draws on the device from the seed and hands to
both.  The program is imported only here, in the model kinds' files and only
when a system is built, so the reference and the tests never load it by
accident.

The models of the pipeline's slots (``SLOTS``: the speaker encoder, the VAD,
the enhancer) come from the configuration's blocks of those names.  A block
that names a ``kind`` is built by ``perfbench/kinds/<kind>.py`` on either
side and handed to the pipeline's keyword for its slot; a block without one
is built as the pipeline builds it (the VAD: ``load_vad`` of its weights;
the enhancer: by each pipeline from ``backend`` and ``weights``).  The
encoder's block always names a kind.
"""
from __future__ import annotations

import copy
import importlib
from dataclasses import dataclass

import torch

from .spec import ROOT, load_kind
from .weights import seeded_state_dict_on_device

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}
# a configuration block -> the pipeline constructor's keyword that takes it
SLOTS = {"encoder": "encoder", "vad": "vad", "enhancer": "enhance_fn"}
PORT = "speech_diarization_tpu_torch"
REFERENCE = "perfbench.reference"


def _path(p: str) -> str:
    return str(ROOT / p)


def _module(program: bool, name: str):
    """The module ``name`` (``"models.port"``) of one side: the port's, or
    the frozen copy's under ``perfbench/reference``."""
    return importlib.import_module(f"{PORT if program else REFERENCE}.{name}")


def pipeline_dict(config: dict) -> dict:
    """The pipeline settings of a configuration, with its checkpoints'
    paths resolved in the checkout.  An enhancer that names a kind keeps its
    ``backend`` here (the auto-scope router and the result's
    ``diagnostics["enhancer"]`` read it) and is built by its kind."""
    d = copy.deepcopy(config.get("pipeline", {}))
    if "overlap_detector" in config:
        d.setdefault("overlap", {})["weights"] = _path(config["overlap_detector"]["weights"])
    if "enhancer" in config:
        e = config["enhancer"]
        enh = d.setdefault("enhance", {})
        enh["backend"] = e["backend"]
        if "kind" not in e:
            enh["weights"] = _path(e["weights"])
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


@dataclass
class Side:
    """What a model kind's ``build`` builds with: one slot of one side."""
    system: Diarizer
    program: bool               # the port's side; else the frozen reference
    stated: bool                # at the configuration's own precision
    slot: str                   # the configuration block's name
    cfg: object                 # this side's pipeline config

    @property
    def device(self) -> str:
        return "cuda" if self.system.device is None else str(self.system.device)

    def module(self, name: str):
        return _module(self.program, name)

    @staticmethod
    def path(p: str) -> str:
        return _path(p)

    def dtype(self, key: str):
        """The dtype the configuration's ``precision[key]`` states (None:
        float32) on the program's side and the control's, else None: the
        reference runs at float32."""
        if not self.stated:
            return None
        return _DTYPES[self.system.config.get("precision", {}).get(key, "float32")]

    def seeded_state(self, net: torch.nn.Module) -> dict:
        """A state_dict for ``net`` drawn from the run's seed on the
        program's device (``harness/weights.py``), once a slot: every side
        gets a copy of the same draw."""
        cache = self.system._seeded
        if self.slot not in cache:
            manifest = {k: tuple(v.shape) for k, v in net.state_dict().items()}
            cache[self.slot] = seeded_state_dict_on_device(manifest, self.system.seed,
                                                           self.device)
        return {k: v.clone() for k, v in cache[self.slot].items()}


class Diarizer:
    """The ``diarizer`` loader: ``program`` is the port's pipeline;
    :meth:`reference` builds the frozen copy's, at float32 (``stated=True``:
    at the configuration's own precision, the control's starting point)."""

    def __init__(self, config: dict, seed: int, device=None):
        self.config = config
        self.seed = int(seed)
        self.device = device
        self._seeded: dict[str, dict] = {}
        check_widths(config)
        self.program = self._build(program=True)

    def _build(self, program: bool, stated: bool = False):
        cfg = _module(program, "config").config_from_dict(pipeline_dict(self.config))
        kw = {}
        for slot, keyword in SLOTS.items():
            block = self.config.get(slot)
            if block is not None and "kind" in block:
                side = Side(self, program, program or stated, slot, cfg)
                kw[keyword] = load_kind(block["kind"]).build(block, side)
        if "encoder" not in kw:
            raise ValueError(f"{self.config.get('name', '?')}: the encoder block names no kind")
        if "vad" not in kw:
            kw["vad"] = _module(program, "models.port").load_vad(
                _path(self.config["vad"]["weights"]))
        pipeline = _module(program, "pipelines.diarize").DiarizationPipeline
        return pipeline(cfg, device=self.device, **kw)

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


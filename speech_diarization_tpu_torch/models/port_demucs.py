"""MVSEP-CDX23 Demucs ``.th`` checkpoint -> :class:`HTDemucsRef`: the JAX
package's ``models/port_demucs.py``.

``demucs.states.save_model`` stores ``{'klass', 'args', 'kwargs', 'state'}``,
so a port is: rebuild :class:`HTDemucsRef` from ``kwargs`` (constructor
names map one to one), drop torch bookkeeping from ``state``, check every
key and shape against the rebuilt net's manifest, and load.

Files are read with ``weights_only=True`` (``models/port.py::
read_torch_file``): a package of ``kwargs`` and ``state`` reads; a file that
pickles ``klass`` (the ``demucs.htdemucs.HTDemucs`` class itself, as a
release ``.th`` does) needs the ``demucs`` package to unpickle, in this
package as in the JAX one, and is refused with an error that names it
(ROADMAP F17).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .demucs_ref import HTDemucsRef
from .port import read_torch_file

#: demucs.htdemucs.HTDemucs kwarg -> HTDemucsRef constructor kwarg
_KWARG_MAP = {
    "sources": "sources",
    "audio_channels": "audio_channels",
    "channels": "channels",
    "growth": "growth",
    "depth": "depth",
    "nfft": "nfft",
    "kernel_size": "kernel_size",
    "stride": "stride",
    "context": "context",
    "context_enc": "context_enc",
    "bottom_channels": "bottom_channels",
    "t_layers": "t_layers",
    "t_heads": "t_heads",
    "t_hidden_scale": "t_hidden_scale",
    "dconv_depth": "dconv_depth",
    "dconv_comp": "dconv_comp",
    "freq_emb": "freq_emb_scale",
    "samplerate": "samplerate",
    "segment": "segment",
}

_DROP_SUFFIXES = ("num_batches_tracked",)


def model_from_kwargs(kwargs: Mapping[str, Any]) -> HTDemucsRef:
    """The graph of a checkpoint's pickled HTDemucs kwargs (training-only
    kwargs are ignored; the graph's map one to one)."""
    cfg = {}
    for src, dst in _KWARG_MAP.items():
        if src in kwargs:
            v = kwargs[src]
            cfg[dst] = tuple(v) if src == "sources" else v
    return HTDemucsRef(**cfg)


def load_htdemucs(src: str | Path | Mapping[str, Any],
                  model: HTDemucsRef | None = None,
                  strict: bool = True) -> HTDemucsRef:
    """A ``demucs.states`` package (or a bare state_dict, or the path of
    either) as a loaded :class:`HTDemucsRef` in eval mode.  With ``kwargs``
    in the package and no ``model``, the architecture is rebuilt from the
    checkpoint; else ``model`` (default: the released ``htdemucs``
    hyperparameters with the CDX23 sources) defines the schema."""
    if isinstance(src, Mapping) and "state" not in src:
        state = src
    else:
        if not isinstance(src, Mapping):
            src = read_torch_file(src)
        if "kwargs" in src and model is None:
            model = model_from_kwargs(src["kwargs"])
        state = src.get("state", src)
        if isinstance(state, Mapping) and state.get("__quantized"):
            raise NotImplementedError(
                "diffq-quantized demucs checkpoints are not supported; "
                "re-export with demucs.states.save_model(quantizer=None)")
    model = model or HTDemucsRef()

    sd: dict[str, np.ndarray] = {}
    for k, v in state.items():
        if k.endswith(_DROP_SUFFIXES) or k.startswith("__"):
            continue
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        sd[k] = np.asarray(v, dtype=np.float32)

    manifest = model.manifest()
    if strict:
        missing = sorted(set(manifest) - set(sd))
        extra = sorted(set(sd) - set(manifest))
        if missing or extra:
            raise ValueError(
                "HTDemucs state_dict schema mismatch: "
                f"missing={missing[:5]} ({len(missing)} total), "
                f"unexpected={extra[:5]} ({len(extra)} total) — check the "
                "checkpoint's kwargs against the HTDemucsRef constructor")
        bad = [(k, manifest[k], tuple(sd[k].shape))
               for k in manifest if tuple(sd[k].shape) != manifest[k]]
        if bad:
            k, want, got = bad[0]
            raise ValueError(f"{len(bad)} shape mismatches, first: {k} expected "
                             f"{want}, got {got}")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if k in manifest}, strict=strict)
    return model.eval()

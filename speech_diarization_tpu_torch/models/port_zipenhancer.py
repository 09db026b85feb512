"""ModelScope ZipEnhancer checkpoint -> :class:`ZipEnhancerRef`: the JAX
package's ``models/port_zipenhancer.py``.

The ``iic/speech_zipenhancer_ans_multiloss_16k_base`` bundle's torch
state_dict (``pytorch_model.bin`` / ``*.pth``) names its generator after
the MP-SENet and icefall-Zipformer2 modules that :class:`ZipEnhancerRef`
reproduces, so porting is a relabel:

1. unwrap ``state_dict`` / ``model`` / ``generator`` and strip one wrapper
   prefix (``generator.`` / ``model.`` / ``module.``, found from the graph's
   key roots),
2. drop the entries that exist only for training (``num_batches_tracked``,
   balancers, whiteners, the discriminator, activation dropout),
3. check every remaining key and shape against the manifest of the target
   configuration (strict), then load.

A file is read with ``weights_only=True`` (``models/port.py::
read_torch_file``).  The bundle's exact configuration rides in its
``config.yaml``: a disagreeing constructor fails here with the JAX loader's
messages, never silently.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .port import read_torch_file
from .zipenhancer_ref import ZipEnhancerRef

#: key roots of the enhancement graph (wrapper-prefix detection)
_ROOTS = ("dense_encoder.", "ts_blocks.", "mask_decoder.", "phase_decoder.")

#: training-only entries, dropped silently
_DROP_SUFFIXES = ("num_batches_tracked",)
_DROP_CONTAINS = ("balancer", "whiten", "discriminator", "activation_dropout")


def zipenhancer_manifest(model: ZipEnhancerRef | None = None
                         ) -> dict[str, tuple[int, ...]]:
    """Expected state_dict key -> shape for ``model``'s configuration (the
    module's own ``state_dict``)."""
    return (model or ZipEnhancerRef()).manifest()


def _strip_prefix(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Remove one wrapper prefix (``generator.`` etc.) when the graph's roots
    appear only under it; nested wrappers are peeled too."""
    if any(k.startswith(_ROOTS) for k in sd):
        return sd
    prefixes = {k.split(".", 1)[0] for k in sd if "." in k}
    for pref in sorted(prefixes):
        stripped = {k[len(pref) + 1:]: v for k, v in sd.items()
                    if k.startswith(pref + ".")}
        if not stripped:
            continue
        result = _strip_prefix(stripped)
        if any(k.startswith(_ROOTS) for k in result):
            return result
    return sd


def load_zipenhancer_modelscope(src: str | Path | Mapping[str, Any],
                                model: ZipEnhancerRef | None = None,
                                strict: bool = True) -> ZipEnhancerRef:
    """A ModelScope ZipEnhancer state_dict (or the path of a checkpoint)
    into ``model`` (default: the published base configuration), returned
    in eval mode.  ``strict``: full key coverage and exact shapes against
    :func:`zipenhancer_manifest`, or ``ValueError`` naming the first
    mismatches."""
    model = model or ZipEnhancerRef()
    if not isinstance(src, Mapping):
        src = read_torch_file(src)
        for key in ("state_dict", "model", "generator"):
            if isinstance(src, Mapping) and isinstance(src.get(key), Mapping):
                src = src[key]
                break

    sd: dict[str, np.ndarray] = {}
    for k, v in src.items():
        if k.endswith(_DROP_SUFFIXES) or any(t in k for t in _DROP_CONTAINS):
            continue
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        sd[k] = np.asarray(v, dtype=np.float32)
    sd = _strip_prefix(sd)

    manifest = zipenhancer_manifest(model)
    if strict:
        missing = sorted(set(manifest) - set(sd))
        extra = sorted(set(sd) - set(manifest))
        if missing or extra:
            raise ValueError(
                "ZipEnhancer state_dict schema mismatch: "
                f"missing={missing[:5]} ({len(missing)} total), "
                f"unexpected={extra[:5]} ({len(extra)} total) — check the "
                "bundle's config.yaml against the ZipEnhancerRef constructor")
        bad = [(k, manifest[k], tuple(sd[k].shape))
               for k in manifest if tuple(sd[k].shape) != manifest[k]]
        if bad:
            k, want, got = bad[0]
            raise ValueError(f"{len(bad)} shape mismatches, first: {k} expected "
                             f"{want}, got {got}")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if k in manifest}, strict=strict)
    return model.eval()

"""Training-state checkpoints and inference-weight exports.

* :func:`save_train_state` / :func:`restore_train_state`: one
  ``torch.save`` file ``{"params", "opt_state", "step"}`` of tensors and
  plain values, readable with ``weights_only=True``
  (``models/port.py::read_torch_file``); restoring copies it into a
  template state built the same way, on any device.
* :func:`export_inference_weights`: the JAX package's flat npz (its keys,
  its ``__meta__``), so each package loads the other's training output.
"""
from __future__ import annotations

from pathlib import Path

import torch

from ..models.port import flat_params, read_torch_file, save_params_npz
from .steps import TrainState


def save_train_state(path: str | Path, state: TrainState) -> None:
    torch.save({
        "params": {k: p.detach().cpu() for k, p in state.params.items()},
        "opt_state": state.opt_state,
        "step": int(state.step),
    }, str(path))


def restore_train_state(path: str | Path, template: TrainState) -> TrainState:
    """Load a checkpoint into ``template`` (its leaves, optimizer and
    schedule, in place) and return it."""
    ckpt = read_torch_file(path)
    missing = sorted(set(template.params) ^ set(ckpt["params"]))
    if missing:
        raise KeyError(f"checkpoint and state disagree on {missing[:5]}")
    with torch.no_grad():
        for k, p in template.params.items():
            p.copy_(ckpt["params"][k].to(p.device))
    template.optimizer.load_state_dict(ckpt["opt_state"]["optimizer"])
    if template.scheduler is not None:
        template.scheduler.load_state_dict(ckpt["opt_state"]["scheduler"])
    template.step = int(ckpt["step"])
    return template


def export_inference_weights(path: str | Path, net: torch.nn.Module,
                             meta: dict | None = None,
                             extra: dict | None = None) -> None:
    """``net``'s weights in the JAX package's flat npz format (float32),
    with ``extra`` leaves (the AAM classifier, which the JAX recipes save
    beside the net) and ``meta`` under ``__meta__``."""
    flat = flat_params(net)
    for k, v in (extra or {}).items():
        flat[k] = v.detach().float().cpu().numpy()
    save_params_npz(flat, path, meta=meta)

"""Silero-VAD artifact tooling: the JAX package's ``models/port_vad.py``.

Silero VAD ships as a TorchScript archive, not as a state_dict of a
published module: its architecture is recoverable only from the serialized
graph.  :func:`silero_state_dict` extracts its raw tensors and
:func:`silero_probs_fn` wraps the TorchScript module as a host oracle of
frame probabilities.  Both were torch code in the JAX package and are
copied here as they are.  Distilling the VAD from that oracle is a training
loop and is not ported (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch


def silero_state_dict(path: str | Path) -> dict[str, np.ndarray]:
    """Named parameters and buffers of the TorchScript archive."""
    mod = torch.jit.load(str(path), map_location="cpu")
    out: dict[str, np.ndarray] = {}
    for name, p in mod.named_parameters():
        out[name] = p.detach().numpy()
    for name, b in mod.named_buffers():
        out.setdefault(name, b.detach().numpy())
    return out


def silero_probs_fn(path: str | Path, sample_rate: int = 16000) -> Callable:
    """The TorchScript model as a host oracle: [T] float32 -> [F] speech
    probabilities of consecutive 512-sample chunks at 16 kHz (256 at 8 kHz),
    the v4+ streaming contract; the model's state is reset per call."""
    mod = torch.jit.load(str(path), map_location="cpu").eval()

    def probs(y: np.ndarray) -> np.ndarray:
        mod.reset_states()
        chunk = 512 if sample_rate == 16000 else 256
        t = (len(y) // chunk) * chunk
        out = []
        with torch.no_grad():
            for i in range(0, t, chunk):
                out.append(float(mod(torch.from_numpy(y[i:i + chunk]), sample_rate)))
        return np.asarray(out, np.float32)

    return probs


def distill_vad_from_silero(*args, **kwargs):
    """Refused: training the VAD against the Silero oracle is a training
    loop (ROADMAP Queue 1 item 8)."""
    raise NotImplementedError(
        "distill_vad_from_silero is a training loop and is not ported yet "
        "(ROADMAP Queue 1 item 8: training)")

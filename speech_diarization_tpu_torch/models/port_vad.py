"""Silero-VAD artifact tooling: the JAX package's ``models/port_vad.py``.

Silero VAD ships as a TorchScript archive, not as a state_dict of a
published module: its architecture is recoverable only from the serialized
graph.  :func:`silero_state_dict` extracts its raw tensors and
:func:`silero_probs_fn` wraps the TorchScript module as a host oracle of
frame probabilities.  Both were torch code in the JAX package and are
copied here as they are.  :func:`distill_vad_from_silero` trains the
recurrent VAD against such an oracle.
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


def distill_vad_from_silero(teacher: str | Path | Callable, steps: int = 500,
                            batch: int = 8, dur_s: float = 4.0, lr: float = 2e-3,
                            seed: int = 0, out_path: str | Path | None = None,
                            init_params: dict | None = None, device=None):
    """Train the recurrent VAD (``VadNet``) to match a teacher's frame
    probabilities on synthetic audio (teacher-student distillation): the
    JAX function's loop, on one device.  ``teacher``: the Silero
    TorchScript file (:func:`silero_probs_fn`) or any callable [T] float32
    -> probabilities of consecutive 512-sample chunks.  The student's 10 ms
    frames take the probability of the teacher chunk that covers them.
    ``init_params``: a flat dict of the student's weights (else the seeded
    init).  Returns (model, metrics with the losses and the held-out
    agreement with the teacher) like ``train_vad_synthetic``."""
    from ..train.recipes import vad_job
    from ..train.synthetic import make_vad_example
    from ..train.checkpoint import export_inference_weights

    teacher = teacher if callable(teacher) else silero_probs_fn(teacher)
    hop, chunk = 160, 512              # student frames, teacher chunks

    def targets(w: np.ndarray) -> np.ndarray:
        tprob = teacher(w)
        f_idx = (np.arange(len(w) // hop + 1) * hop // chunk).clip(
            0, len(tprob) - 1)
        return tprob[f_idx]

    def example(rng, dur):
        w, _ = make_vad_example(rng, dur)
        return w, targets(w)

    job = vad_job(batch, dur_s, lr, seed, "gru", example, init_params, device)
    metrics = {"loss": []}
    for i in range(steps):
        loss = job.step()
        if (i + 1) % 50 == 0 or i == 0:
            metrics["loss"].append(float(loss))
    w, _ = make_vad_example(np.random.default_rng(seed + 1), dur_s)
    tp = targets(w)
    with torch.no_grad():
        sp = job.model.probs(job.batch_tensors((w,))[0]).cpu().numpy()
    n = min(len(sp), len(tp))
    metrics["teacher_agreement"] = float(((sp[:n] > 0.5) == (tp[:n] > 0.5)).mean())
    if out_path is not None:
        export_inference_weights(out_path, job.net)
    return job.model, metrics

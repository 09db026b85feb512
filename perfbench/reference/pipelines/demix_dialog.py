"""The demix-dialog front-end, plainly: a 16 kHz mono wave -> the dialog
stem of an ensemble of separators, back at 16 kHz.

1. The wave, on the host in float64, resampled to 44.1 kHz by scipy's
   ``resample_poly`` (Kaiser-windowed polyphase, its defaults) and stored
   in float32, duplicated into two channels;
2. 10 s chunks (``chunk_s * 44100`` samples) every ``(1 - overlap)`` of a
   chunk, the last one zero-padded to a whole chunk (a mix no longer than
   one chunk runs alone, at its own length);
3. each chunk through every net, the ensemble's mean;
4. the chunks' stems weighted by a symmetric Hann window of a chunk plus
   1e-3, summed where they overlap and divided by the summed weights, cut
   to the mix's length;
5. the dialog stem (the last source), the mean of its two channels,
   resampled to 16 kHz as in 1, then zero-padded or cut to the input's
   length.

No checkpoint is read: the nets are handed in.  Everything on the device
runs in float32 (the reference nets turn TF32 off when they are built).
"""
from __future__ import annotations

import math
from math import gcd

import numpy as np
import torch

DEMIX_SR = 44100
SR = 16000


def resample(y: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """scipy's ``resample_poly`` in float64 along the last axis, float32
    out."""
    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    out = resample_poly(np.asarray(y, np.float64), target_sr // g, orig_sr // g, axis=-1)
    return out.astype(np.float32)


class DemixDialog:
    """``[T]`` tensor at 16 kHz -> ``[T]`` dialog stem at 16 kHz on
    ``device``.  ``nets``: separators ``[B, 2, L] -> [B, S, 2, L]``, the
    dialog stem last; ``batch``: chunks a forward."""

    def __init__(self, nets, device, chunk_s: float = 10.0, overlap: float = 0.25,
                 batch: int = 40):
        self.device = torch.device(device)
        self.nets = [n.to(self.device).eval() for n in nets]
        self.chunk_s = chunk_s
        self.overlap = overlap
        self.batch = batch

    def separate(self, x: torch.Tensor) -> torch.Tensor:
        """[2, T] at 44.1 kHz -> [S, 2, T]: steps 2-4."""
        t = x.shape[-1]
        chunk = int(self.chunk_s * DEMIX_SR)
        if t <= chunk:
            return self._mean(x[None])[0]
        hop = int(chunk * (1.0 - self.overlap))
        n = 1 + math.ceil((t - chunk) / hop)
        padded = torch.nn.functional.pad(x, (0, (n - 1) * hop + chunk - t))
        chunks = torch.stack([padded[:, i * hop:i * hop + chunk] for i in range(n)])
        sep = self._mean(chunks)                                  # [n, S, 2, chunk]
        w = torch.hann_window(chunk, periodic=False, dtype=torch.float64,
                              device=x.device).float() + 1e-3
        out = torch.zeros(sep.shape[1:3] + ((n - 1) * hop + chunk,), device=x.device)
        den = torch.zeros((n - 1) * hop + chunk, device=x.device)
        for i in range(n):
            out[..., i * hop:i * hop + chunk] += sep[i] * w
            den[i * hop:i * hop + chunk] += w
        return (out / den)[..., :t]

    def _mean(self, chunks: torch.Tensor) -> torch.Tensor:
        total = None
        for net in self.nets:
            sep = torch.cat([net(chunks[i:i + self.batch])
                             for i in range(0, chunks.shape[0], self.batch)])
            total = sep if total is None else total + sep
        return total / len(self.nets)

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        yn = y.detach().to("cpu", torch.float32).numpy()
        up = resample(yn, SR, DEMIX_SR)
        x = torch.from_numpy(np.stack([up, up])).to(self.device)
        with torch.inference_mode():
            dialog = self.separate(x)[-1].mean(dim=0).cpu().numpy()
        out = resample(dialog, DEMIX_SR, SR)
        n = yn.shape[-1]
        out = np.pad(out, (0, max(0, n - out.shape[-1])))[:n]
        return torch.from_numpy(out).to(self.device)

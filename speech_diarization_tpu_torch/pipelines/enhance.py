"""Speech enhancement before diarization: GTCRN, wav -> wav, on the
net's device.

The JAX package's ``pipelines/enhance.py`` for the ``gtcrn`` backend:
STFT (sqrt-Hann, 512 / 256, centred) -> GTCRN -> iSTFT, and for audio
longer than ``chunk_s`` chunks of ``chunk_s`` at a stride of ``chunk_s -
overlap_s`` merged by a Hann-windowed overlap-add.  The JAX package pads
each batch of chunks to four rows with zero rows; the rows are independent
in eval mode, so only the real chunks run here (up to four a forward).

The ZipEnhancer and demix backends are not ported (ROADMAP Queue 1) and
raise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dsp.framing import num_frames
from ..dsp.ola import ola_normalization, overlap_add
from ..dsp.stft import hann_window, istft_ri, stft_ri
from ..models.gtcrn import GTCRN
from ..utils.logging import get_logger

log = get_logger("enhance")

_UNPORTED = "is not ported yet (ROADMAP Queue 1: the next enhancer slice)"


class GtcrnEnhancer:
    """GTCRN wav -> wav enhancement at 16 kHz with long-audio chunked OLA.
    Runs on the device of ``net``; inputs are moved there."""

    SAMPLE_RATE = 16000
    BATCH_CHUNKS = 4      # chunks a forward: bounds the memory of long files

    def __init__(self, net: GTCRN, chunk_s: float = 360.0, overlap_s: float = 1.0):
        self.net = net.eval()
        self.chunk_s = chunk_s
        self.overlap_s = overlap_s

    def forward(self, wavs: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T]: STFT -> GTCRN -> iSTFT."""
        return istft_ri(self.net(stft_ri(wavs)), length=wavs.shape[-1])

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """Enhance a [T] float32 waveform of any length."""
        dev = next(self.net.parameters()).device
        y = y.to(dev, torch.float32)
        t = y.shape[-1]
        sr = self.SAMPLE_RATE
        chunk = int(self.chunk_s * sr)
        with torch.inference_mode():
            if t <= chunk:
                return self.forward(y[None])[0]
            stride = int((self.chunk_s - self.overlap_s) * sr)
            n = num_frames(t, chunk, stride, pad_tail=True)
            ypad = F.pad(y, (0, (n - 1) * stride + chunk - t))
            chunks = ypad.unfold(0, chunk, stride)                 # [n, chunk]
            bc = self.BATCH_CHUNKS
            enh = torch.cat([self.forward(chunks[i:i + bc])
                             for i in range(0, n, bc)])
            window = hann_window(chunk, periodic=False, device=dev)
            num = overlap_add(enh * window, stride)
            den = ola_normalization(n, stride, window)
            return (num / den)[:t]


def default_weights_path(backend: str):
    """Shipped default checkpoint for ``backend`` (None when nothing
    ships): lets a caller that enables enhancement by default check that a
    trained net exists."""
    from ..utils.weights import prefer_weights

    return prefer_weights({
        "gtcrn": ("gtcrn_mc.npz", "gtcrn_synthetic.npz"),
        "zipenhancer": ("zipenhancer_mc.npz", "zipenhancer_synthetic.npz"),
        "demix-dialog": ("demix_mc.npz", "demix_synthetic.npz"),
    }.get(backend, ()))


def make_enhance_fn(backend: str, weights=None, device=None,
                    chunk_s: float = 360.0, overlap_s: float = 1.0):
    """The pipeline's enhancer: ``[T]`` tensor -> ``[T]`` tensor on
    ``device``.  ``weights``: a checkpoint path overriding the shipped one.
    ``gtcrn`` only; the other backends raise ``NotImplementedError``."""
    if backend in ("zipenhancer", "zipenhancer-ref", "demix-dialog"):
        raise NotImplementedError(f"enhancement backend {backend!r} " + _UNPORTED)
    if backend != "gtcrn":
        raise ValueError(f"unknown enhancement backend: {backend}")
    from ..models.port import load_gtcrn

    path = weights if weights is not None else default_weights_path("gtcrn")
    if path is None:
        raise FileNotFoundError("gtcrn: no weights given and none ship")
    log.info("gtcrn: loading weights %s", path)
    return GtcrnEnhancer(load_gtcrn(path).to(device or "cpu"), chunk_s, overlap_s)

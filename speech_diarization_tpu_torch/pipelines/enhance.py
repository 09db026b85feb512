"""Speech enhancement before diarization, wav -> wav at 16 kHz on the
net's device: the JAX package's ``pipelines/enhance.py``.

* ``gtcrn``: STFT (sqrt-Hann, 512 / 256, centred) -> GTCRN -> iSTFT; audio
  longer than ``chunk_s`` runs in chunks of ``chunk_s`` at a stride of
  ``chunk_s - overlap_s`` merged by a Hann-windowed overlap-add.
* ``zipenhancer``: :func:`windowed_enhance` over ``ZipEnhancerModel``: 2 s
  windows at a 75 % hop in batches, a sqrt-Hann overlap-add normalized by
  the window sum, and a peak limit.
* ``demix-dialog``: the separation front-end, 16 kHz mono -> 44.1 kHz
  stereo on the host -> :class:`~.demix.EnsembleDemixer` on the device ->
  the dialog stem -> 16 kHz on the host.

* ``zipenhancer-ref``: the published ZipEnhancer graph
  (:class:`~..models.zipenhancer_ref.ZipEnhancerRef`, the architecture of the
  ModelScope bundle) through :func:`windowed_enhance`, as ``zipenhancer``.

The JAX package pads each last batch of chunks or windows with zero rows to
a fixed shape; the rows are independent in eval mode, so only the real ones
run here.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.framing import num_frames
from ..dsp.ola import ola_normalization, overlap_add
from ..dsp.stft import hann_window, istft_ri, sqrt_hann_window, stft_ri
from ..models.gtcrn import GTCRN
from ..utils.device import disable_tf32, resolve_device
from ..utils.logging import count, get_logger, stage_timer

log = get_logger("enhance")

class GtcrnEnhancer:
    """GTCRN wav -> wav enhancement with long-audio chunked OLA.  Runs on
    the device of ``net``; inputs are moved there.  ``batch_chunks`` chunks
    go through one forward (it bounds the memory of long files and changes
    no result)."""

    def __init__(self, net: GTCRN, n_fft: int = 512, hop: int = 256,
                 chunk_s: float = 360.0, overlap_s: float = 1.0,
                 sample_rate: int = 16000, batch_chunks: int = 4):
        self.net = net.eval()
        self.n_fft = n_fft
        self.hop = hop
        self.chunk_s = chunk_s
        self.overlap_s = overlap_s
        self.sample_rate = sample_rate
        self.batch_chunks = batch_chunks

    def forward(self, wavs: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, T]: STFT -> GTCRN -> iSTFT."""
        spec = stft_ri(wavs, self.n_fft, self.hop)
        return istft_ri(self.net(spec), self.n_fft, self.hop, length=wavs.shape[-1])

    def __call__(self, y: torch.Tensor) -> torch.Tensor:
        """Enhance a [T] float32 waveform of any length."""
        dev = next(self.net.parameters()).device
        y = y.to(dev, torch.float32)
        t = y.shape[-1]
        sr = self.sample_rate
        chunk = int(self.chunk_s * sr)
        with torch.inference_mode():
            if t <= chunk:
                return self.forward(y[None])[0]
            stride = int((self.chunk_s - self.overlap_s) * sr)
            n = num_frames(t, chunk, stride, pad_tail=True)
            ypad = F.pad(y, (0, (n - 1) * stride + chunk - t))
            chunks = ypad.unfold(0, chunk, stride)                 # [n, chunk]
            bc = self.batch_chunks
            enh = torch.cat([self.forward(chunks[i:i + bc])
                             for i in range(0, n, bc)])
            window = hann_window(chunk, periodic=False, device=dev)
            num = overlap_add(enh * window, stride)
            den = ola_normalization(n, chunk, stride, window)
            return (num / den)[:t]


def windowed_enhance(model_fn, y: torch.Tensor, sample_rate: int = 16000,
                     window_s: float = 2.0, hop_ratio: float = 0.75,
                     batch_size: int = 64, peak_limit: float = 0.99) -> torch.Tensor:
    """Windowed batch enhancement of a [T] waveform with sqrt-Hann OLA.

    ``model_fn``: a ``[B, L] -> [B, L]`` denoiser on ``y``'s device.  The
    windows (``window_s`` long, every ``window_s * hop_ratio``) are an
    ``unfold`` view of the zero-padded wave, run ``batch_size`` at a time;
    the overlap-add is normalized by the folded window sum, and an output
    whose peak exceeds 1.0 is scaled by ``peak_limit / peak``."""
    t = y.shape[-1]
    l = int(window_s * sample_rate)
    hop = int(round(l * hop_ratio))
    n = num_frames(t, l, hop, pad_tail=True) if t > l else 1
    patches = F.pad(y, (0, max(0, (n - 1) * hop + l - t))).unfold(0, l, hop)
    enh = torch.cat([model_fn(patches[i:i + batch_size])
                     for i in range(0, n, batch_size)])
    w = sqrt_hann_window(l, periodic=False, device=y.device)
    out = (overlap_add(enh * w, hop) / ola_normalization(n, l, hop, w))[:t]
    peak = out.abs().max()
    return torch.where(peak > 1.0, out * (peak_limit / peak), out)


def enhance_batch(root, backend: str = "gtcrn", weights=None, device=None,
                  suffix: str = "-enhanced", target_sr: int = 16000,
                  **kwargs) -> list:
    """Enhance every audio file under ``root`` into a sibling
    ``<root><suffix>`` tree of mono WAVs at ``target_sr`` (the rate the
    files are read at and handed to the enhancer), skipping files whose
    output exists (resume).  The enhancer is :func:`make_enhance_fn`'s."""
    from pathlib import Path

    from ..io.audio import read_audio, write_wav
    from ..io.walk import expand_audios

    audios, proot = expand_audios(root)
    troot = proot.with_name(f"{proot.stem}{suffix}")
    fn = make_enhance_fn(backend, weights=weights, device=device, **kwargs)
    written = []
    for apath in audios:
        rel = apath.relative_to(proot) if apath.is_relative_to(proot) else Path(apath.name)
        tpath = (troot / rel).with_suffix(".wav")
        if tpath.exists():
            continue
        y, sr = read_audio(apath, target_sr=target_sr, mono=True)
        write_wav(tpath, fn(torch.from_numpy(y)).cpu().numpy(), sr)
        written.append(tpath)
        log.info("enhanced %s -> %s", apath, tpath)
    return written


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


def _checkpoint(backend: str, weights):
    """``weights`` (a mapping of arrays as it is, or a path), else the
    shipped checkpoint of ``backend``."""
    if isinstance(weights, Mapping):
        return weights
    path = weights if weights is not None else default_weights_path(backend)
    if path is None:
        raise FileNotFoundError(f"{backend}: no weights given and none ship")
    log.info("%s: loading weights %s", backend, path)
    return path


def _zipenhancer_ref(weights):
    """:class:`ZipEnhancerRef` at its published defaults with ``weights``
    (an ``.npz`` path or a flat mapping of arrays keyed by its state_dict
    names), or random weights with the JAX package's warning.  The random
    draw comes from a ``torch.Generator`` seeded 0 and cannot equal the
    JAX package's ``jax.random`` draw."""
    from ..models.port import _load_flat
    from ..models.registry import seeded_init
    from ..models.zipenhancer_ref import ZipEnhancerRef

    if weights is not None:
        return _load_flat(ZipEnhancerRef(), _checkpoint("zipenhancer-ref", weights))
    log.warning("zipenhancer-ref: no checkpoint given — RANDOM weights; "
                "'enhanced' audio will be garbage. Port the ModelScope "
                "artifact via models/port_zipenhancer.load_zipenhancer_modelscope.")
    return seeded_init(ZipEnhancerRef(), 0)


def make_enhance_fn(backend: str, weights=None, device=None, nets=None, **kwargs):
    """The pipeline's enhancer: ``[T]`` float32 tensor -> ``[T]`` tensor on
    ``device`` (``None``: the card; raises without CUDA).  ``weights``: a
    checkpoint path overriding the shipped one, or (gtcrn, zipenhancer,
    zipenhancer-ref) a flat mapping of arrays keyed by the net's state_dict
    names, as the CLI passes a ported torch checkpoint (the JAX package's
    ``params``).  ``kwargs`` go to the backend: ``chunk_s`` / ``overlap_s``
    (gtcrn), ``window_s`` / ``hop_ratio`` / ``batch_size`` (zipenhancer,
    zipenhancer-ref), and the :class:`~.demix.EnsembleDemixer` options
    (demix-dialog).  ``nets`` (demix-dialog only): the separators of the
    ensemble as modules, in place of ``weights`` or the checkpoints on disk.

    The demix-dialog enhancer's stages are spans under the caller's:
    ``demix.download`` and ``demix.fetch`` (waits, ``d2h_bytes``),
    ``demix.resample-in`` (``samples``) and ``demix.resample-out`` on the
    host, the ensemble's ``demix.upload`` (a wait, ``h2d_bytes``),
    ``demix.separate`` and ``demix.ola`` (:class:`~.demix.EnsembleDemixer`),
    and ``demix.return`` (a wait, ``h2d_bytes``), the dialog stem's copy
    back to the device."""
    if backend not in ("gtcrn", "zipenhancer", "zipenhancer-ref", "demix-dialog"):
        raise ValueError(f"unknown enhancement backend: {backend}")
    if nets is not None and weights is not None:
        raise ValueError(f"{backend}: pass weights= or nets=, not both")
    if nets is not None and backend != "demix-dialog":
        raise ValueError(f"{backend}: nets= is taken by the demix-dialog backend only")
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    from ..models.port import load_demixer, load_gtcrn, load_zipenhancer

    if backend == "gtcrn":
        return GtcrnEnhancer(load_gtcrn(_checkpoint(backend, weights)).to(dev), **kwargs)
    if backend in ("zipenhancer", "zipenhancer-ref"):
        net = (load_zipenhancer(_checkpoint(backend, weights)) if backend == "zipenhancer"
               else _zipenhancer_ref(weights)).to(dev)

        def zip_fn(y: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return windowed_enhance(net, y.to(dev, torch.float32), **kwargs)

        return zip_fn
    # demix-dialog: the default demixer is the ensemble's own choice
    # (ported .th checkpoints, then demix_mc.npz, then demix_synthetic.npz)
    from ..dsp.resample import resample_host
    from .demix import DEMIX_SR, EnsembleDemixer

    if weights is not None:
        nets = [load_demixer(_checkpoint(backend, weights))]
    dmx = EnsembleDemixer(nets, device=dev, **kwargs)
    sr = 16000

    def demix_fn(y: torch.Tensor) -> torch.Tensor:
        with stage_timer(log, "demix.download", wait=True):
            yn = y.detach().to("cpu", torch.float32).numpy()
            count("d2h_bytes", yn.nbytes)
        with stage_timer(log, "demix.resample-in"):
            up = resample_host(yn, sr, DEMIX_SR)
            stereo = np.stack([up, up])
            count("samples", up.shape[-1])
        stems = dmx.separate_on_device(stereo, DEMIX_SR)
        with stage_timer(log, "demix.fetch", wait=True):
            dialog = stems[2].mean(dim=0).cpu().numpy()
            count("d2h_bytes", dialog.nbytes)
        with stage_timer(log, "demix.resample-out"):
            out = resample_host(dialog, DEMIX_SR, sr)
            out = np.pad(out, (0, max(0, yn.shape[-1] - out.shape[-1])))[:yn.shape[-1]]
        with stage_timer(log, "demix.return", wait=True):
            count("h2d_bytes", out.nbytes)
            return torch.from_numpy(out).to(dev)

    return demix_fn

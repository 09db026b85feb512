"""Dialog / effect / music separation with chunked ensemble application, the
JAX package's ``pipelines/demix.py``: stereo 44.1 kHz in, ``[3, 2, T]``
stems out (music, effect, dialog), the mean over an ensemble of separator
weight sets, overlapped 10 s chunks merged by a windowed overlap-add, and a
batch walk that writes ``<out>/<stem>/<file>.wav`` trees.

The chunks, the separator and the overlap-add of all six stem channels run
on the nets' device; the waveform is copied there once and the stems (or
the one stem a caller needs) back once.  The separator is an ensemble of
HTDemucs ``.th`` checkpoints (``SDTPU_DEMUCS_CKPTS``, ``:``-separated, or
``weights/*.th``) when any exists, as in the JAX package, else the shipped
U-Net.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from ..dsp.framing import frame_signal, num_frames
from ..dsp.ola import ola_normalization, overlap_add
from ..dsp.stft import hann_window
from ..io.audio import read_audio, write_wav
from ..io.walk import expand_audios
from ..models.demix import STEMS
from ..utils.device import disable_tf32, resolve_device
from ..utils.logging import count, get_logger, stage_timer

log = get_logger("demix")

DEMIX_SR = 44100


def demucs_style_read(source, target_sr: int = DEMIX_SR) -> tuple[np.ndarray, int]:
    """Stereo read: mono is duplicated, more than two channels cut to two."""
    y, sr = read_audio(source, target_sr=target_sr, mono=False)
    if y.ndim == 1:
        y = y[None, :]
    if y.shape[0] == 1:
        y = np.repeat(y, 2, axis=0)
    if y.shape[0] > 2:
        y = y[:2]
    return y.astype(np.float32), sr


class EnsembleDemixer:
    """Mean-of-ensemble separator over overlapped chunks.

    ``nets``: separators of one geometry (the ensemble); default: the
    HTDemucs checkpoints that exist among ``SDTPU_DEMUCS_CKPTS`` (else
    ``weights/*.th``), each through ``models/port_demucs.load_htdemucs``;
    with none, the shipped ``demix_mc.npz``, else ``demix_synthetic.npz``
    (an ensemble of one).  A named checkpoint that does not exist is dropped
    (ROADMAP F9).  ``device``: ``None`` is the card (raises without
    CUDA)."""

    CHUNK_BATCH = 40      # chunks a forward: bounds the memory of long files

    def __init__(self, nets: Sequence[torch.nn.Module] | None = None,
                 chunk_s: float = 10.0, overlap: float = 0.25, shifts: int = 1,
                 max_shift_s: float = 0.5, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            disable_tf32()
        if nets is None:
            from ..models.port import load_demixer
            from ..utils import weights

            env = os.environ.get("SDTPU_DEMUCS_CKPTS", "")
            ckpts = ([Path(p) for p in env.split(":") if p]
                     or sorted(weights.WEIGHTS_ROOT.glob("*.th")))
            ckpts = [c for c in ckpts if c.exists()]
            if ckpts:
                from ..models.port_demucs import load_htdemucs

                nets = [load_htdemucs(c) for c in ckpts]
                if any(n.manifest() != nets[0].manifest() for n in nets[1:]):
                    raise ValueError(
                        "demucs ensemble checkpoints disagree on architecture")
                log.info("demix: HTDemucs ensemble of %d ported checkpoints",
                         len(nets))
        if nets is None:
            default = weights.prefer_weights(("demix_mc.npz", "demix_synthetic.npz"))
            if default is None:
                raise FileNotFoundError("demix: no weights given and none ship")
            log.info("demix: using shipped trained weights %s (ensemble of 1)",
                     default)
            nets = [load_demixer(default)]
        self.nets = [n.to(self.device).eval() for n in nets]
        self.chunk_s = chunk_s
        self.overlap = overlap
        self.shifts = max(1, int(shifts))
        self.max_shift_s = max_shift_s

    @property
    def instruments(self) -> tuple[str, ...]:
        return STEMS

    def separate(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        """[2, T] at 44.1 kHz -> [3, 2, T] (ensemble mean, chunked OLA).

        With ``shifts > 1`` the input is also separated at ``shifts`` offsets
        spread evenly below ``max_shift_s``, re-aligned and averaged."""
        return self.separate_on_device(wav, sample_rate).cpu().numpy()

    def separate_on_device(self, wav: np.ndarray, sample_rate: int) -> torch.Tensor:
        """:meth:`separate`, its stems left on the nets' device (a caller
        that needs one stem copies only that one)."""
        if wav.ndim != 2 or wav.shape[0] != 2:
            raise ValueError(f"input must be [2, T] stereo, got {wav.shape}")
        if sample_rate != DEMIX_SR:
            raise ValueError(f"sample rate must be {DEMIX_SR}, got {sample_rate}")
        # a copy from pageable memory: the host waits for the stream
        with stage_timer(log, "demix.upload", wait=True):
            x = torch.from_numpy(np.ascontiguousarray(wav, np.float32)).to(self.device)
            count("h2d_bytes", x.numel() * 4)
        with torch.inference_mode():
            if self.shifts == 1:
                return self._separate_once(x, sample_rate)
            t = x.shape[-1]
            max_shift = int(self.max_shift_s * sample_rate)
            padded = torch.nn.functional.pad(x, (max_shift, max_shift))
            acc = None
            for s in range(self.shifts):
                off = int(round(s * max_shift / self.shifts))
                out = self._separate_once(
                    padded[:, max_shift - off:2 * max_shift - off + t], sample_rate)
                out = out[:, :, off:off + t]
                acc = out if acc is None else acc + out
            return acc / self.shifts

    def _forward(self, chunks: torch.Tensor) -> torch.Tensor:
        """[n, 2, L] -> [n, 3, 2, L]: the ensemble mean, in the span
        ``demix.separate`` (counters ``nets``, ``chunks`` and ``batches``,
        the nets' forwards)."""
        n = chunks.shape[0]
        with stage_timer(log, "demix.separate", device=chunks.is_cuda):
            count("nets", len(self.nets))
            count("chunks", n)
            count("batches", len(self.nets) * -(-n // self.CHUNK_BATCH))
            acc = None
            for net in self.nets:
                sep = torch.cat([net(chunks[i:i + self.CHUNK_BATCH])
                                 for i in range(0, n, self.CHUNK_BATCH)])
                acc = sep if acc is None else acc + sep
            return acc / len(self.nets)

    def _separate_once(self, x: torch.Tensor, sample_rate: int) -> torch.Tensor:
        t = x.shape[-1]
        chunk = int(self.chunk_s * sample_rate)
        hop = int(chunk * (1.0 - self.overlap))
        if t <= chunk:
            return self._forward(x[None])[0]
        n = num_frames(t, chunk, hop, pad_tail=True)
        sep = self._forward(frame_signal(x, chunk, hop).transpose(0, 1))
        n_src, n_ch = sep.shape[1:3]
        with stage_timer(log, "demix.ola", device=x.is_cuda):
            window = hann_window(chunk, periodic=False, device=x.device) + 1e-3
            # every stem channel of every chunk in one overlap-add
            frames = (sep * window).permute(1, 2, 0, 3).reshape(n_src * n_ch, n, chunk)
            out = overlap_add(frames, hop) / ola_normalization(n, chunk, hop, window)
            return out.reshape(n_src, n_ch, -1)[:, :, :t]


def separate_dialog(input_path: str | Path, output: str | Path | None = None,
                    demixer: EnsembleDemixer | None = None) -> list[Path]:
    """Walk the audio files under ``input_path``, separate each, and write
    ``<output>/<stem>/<file>.wav`` (default output: ``<root>-dialog``)."""
    audios, root = expand_audios(input_path)
    troot = Path(output) if output else root.with_name(f"{root.stem}-dialog")
    demixer = demixer or EnsembleDemixer()
    written: list[Path] = []
    for apath in audios:
        rel = apath.relative_to(root) if apath.is_relative_to(root) else apath.name
        wav, sr = demucs_style_read(apath)
        stems = demixer.separate(wav, sr)
        for name, stem in zip(demixer.instruments, stems):
            tpath = (troot / name / rel).with_suffix(".wav")
            write_wav(tpath, stem, sr)
            written.append(tpath)
        log.info("separated %s -> %s", apath, troot)
    return written

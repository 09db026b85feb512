"""The flagship diarizer in PyTorch: the streamed ingest, and the
whole-file path that noisy input takes through an enhancement front-end.

Streamed: read -> quantize to int16 -> 60 s chunks with neighbour context
-> ONE per-chunk device program (dequantize; the overlap detector's hard
decisions on 5 s windows of the raw chunk; loudness gain metered on the
chunk's core, DC, pre-emphasis, log-mel, VAD probabilities, frame energy,
streaming ECAPA grid) -> one packed device-to-host copy -> host tail (VAD
post, SCD, segment embeddings, spectral clustering, window refine,
conservative merge, frame reassignment when on, adjacent merge, overlap
rescue).

Whole-file ("legacy") path, taken when the enhancement front-end engages
(scope ``auto`` and a probe SNR under ``auto_snr_db``, or a forced scope),
the chunk geometry cannot stream, or the grid is the windowed one (an
encoder that is not streaming-trained, ``grid_backend='windowed'``, or a
grid off the 10 ms mel hop): quantize the whole file -> SNR and
noise-floor probe -> the enhancer (GTCRN, ZipEnhancer or the demix-dialog
separator) on the dequantized file (the VAD's input only under scopes
``auto`` and ``vad``, everything under ``full``; on the auto-route a
speech-shaped floor swaps the whole file for its dialog stem when a
separation-grade demixer is present) -> whole-file loudness, DC,
pre-emphasis -> VAD over 15 s chunks (one batched log-mel launch a group)
and frame energy -> the streaming ECAPA grid in chunks of up to 600
windows, or the windowed grid (every 2 s window through the per-utterance
encoder, batches of ``embed.batch_size``: one batched log-mel launch each)
-> one device-to-host copy -> the same host tail, which clusters by
``cluster.method`` (spectral, AHC, HDBSCAN, two-stage HDBSCAN), whitening
the segment embeddings first when ``embed.whiten``.  The whole-file path is
also taken with ``embed.mode='bucketed'`` (each segment's own snippet
through the per-utterance encoder, :func:`~..segment.embed.
embed_segments_bucketed`, instead of the grid's masked means), a prefetched
source (:meth:`DiarizationPipeline.prefetch`) and ``collect_diagnostics``.

The counterpart of the JAX package's ``pipelines/diarize.py`` (``__call__``
-> ``_streamed_start`` / ``_legacy_call`` -> ``_segments_from_grid``, and
the functional :func:`diarize`).  The enhancer may be any backend of
``pipelines/enhance.py``, the published ZipEnhancer graph
(``zipenhancer-ref``) included; the auto-route's demixer is the HTDemucs
ensemble of ``.th`` checkpoints when any is present.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import cluster as cluster_mod
from ..config import DiarizationConfig
from ..dsp.framing import num_frames
from ..dsp.loudness import integrated_loudness, loudness_normalize
from ..dsp.mel import fused_log_mel
from ..dsp.preprocess import preemphasis
from ..io.audio import read_audio
from ..segment import (
    add_overlap_segments,
    conservative_merge,
    detect_overlap_regions,
    embed_segments_bucketed,
    embed_windows,
    embed_windows_streaming,
    frame_energy_db_chunk,
    frame_reassign,
    make_seg_hard_fn,
    merge_adjacent,
    regions_from_hard_acts,
    scd_split,
    segment_embeddings_from_grid,
    vad_segments_from_probs,
    window_starts,
)
from ..types import Segment, SegmentArray
from ..utils.blas import blas_threads, single_blas_thread
from ..utils.device import disable_tf32, resolve_device
from ..utils.logging import count, current_file, file_scope, get_logger, stage_timer
from .chunking import chunked_framewise

log = get_logger("diarize")

_CLUSTER_METHODS = ("spectral", "ahc", "hdbscan", "hdbscan2")


@dataclass
class DiarizationResult:
    segments: SegmentArray
    vad_segments: SegmentArray
    num_speakers: int
    diagnostics: dict[str, Any] = field(default_factory=dict)

    def to_segments(self) -> list[Segment]:
        return self.segments.to_segments()


class DiarizationPipeline:
    """Configurable wav -> segments pipeline on one device.

    Args:
        cfg: unified config.  ``overlap.enabled`` (the default) runs the
            segmentation model inside the per-chunk program and the overlap
            rescue on the host; ``reseg.enabled`` runs frame reassignment.
        encode_fn: a callable ``[B, T] -> [B, D]`` (the JAX package's
            keyword): it gets a float32 tensor on this pipeline's device and
            may return a tensor or an array, which is moved there.  It
            computes the windowed grid and is :meth:`encode_fn` for the
            bucketed mode and the segmentation engine.  Without ``encoder``
            no shipped encoder is loaded (the windowed grid, as in the JAX
            package); with one, the encoder keeps the streaming grid.
        vad_probs_fn: a callable ``[B, T] -> [B, F]`` frame probabilities
            (the JAX package's keyword), in place of ``vad``: it runs in
            the per-chunk program and over the whole-file path's 15 s
            chunks; what it returns is moved to this pipeline's device.
        enhance_fn: a callable wave -> wave in place of the enhancer of
            ``cfg.enhance`` (taken even when ``enhance.enabled`` is off, as
            in the JAX package); what it returns is moved to this
            pipeline's device.
        encoder: a module with ``encode_batch`` ([B, T] waveforms -> [B, D]):
            an :class:`~..models.ecapa.EcapaModel`, ``ERes2NetV2Model`` or
            ``CamPlusPlusModel`` (``models.registry.make_encoder_model``);
            default: the first shipped encoder of ``ENCODER_PREFERENCE``.  A
            streaming-trained ECAPA runs the streamed ingest; any other
            encoder the windowed grid.  An encoder spread over a mesh
            (``parallel.make_sharded_encode_fn``) is taken as it is:
            windowed grid, outputs on its mesh's first device.
        vad: a :class:`~..models.vad.VadModel` (conv TCN or GRU net) or
            :class:`~..models.vad.EnergyVad`; default: the energy VAD at
            ``cfg.vad``'s window and hop, as in the JAX package (the CLI and
            the bench pass the shipped conv VAD).
        device: ``None`` (the card; raises without CUDA) or ``"cpu"``.

    ``enhance.enabled`` (the default) loads the enhancer of
    ``enhance.backend`` (GTCRN by default) for the whole-file path, or
    drops the stage with a warning when no trained weights ship.

    A call takes a path, a host array, an ``(array, sr)`` pair or what
    :meth:`prefetch` returned; :meth:`encode_fn` is the per-utterance
    encoder that the bucketed mode and the segmentation engine call.
    """

    _PAD_BUCKET_S = 60.0   # chunk length of the streamed ingest
    _SNR_FRAME = 800       # 50 ms @ 16 kHz energy frames of the SNR probe

    def __init__(self, cfg: DiarizationConfig | None = None, encode_fn=None,
                 vad_probs_fn=None, enhance_fn=None, encoder=None, vad=None,
                 device: str | torch.device | None = None):
        self.cfg = cfg = cfg or DiarizationConfig()
        if cfg.embed.mode not in ("grid", "bucketed"):
            raise ValueError(f"unknown embed mode {cfg.embed.mode!r}")
        if cfg.cluster.method not in _CLUSTER_METHODS:
            raise ValueError(f"unknown cluster method {cfg.cluster.method!r}")
        if vad is not None and vad_probs_fn is not None:
            raise ValueError("pass vad or vad_probs_fn, not both")
        self.device = resolve_device(device)
        self._on_card = self.device.type == "cuda"
        if self._on_card:
            disable_tf32()
        self._encode = None if encode_fn is None else self._on_device(encode_fn)
        self.enhance_fn = None if enhance_fn is None else self._on_device(enhance_fn)
        e = cfg.enhance
        if enhance_fn is None and e.enabled:
            from .enhance import default_weights_path, make_enhance_fn

            if e.weights is None and default_weights_path(e.backend) is None:
                # random-weight 'denoising' is worse than none
                log.warning("enhance: enabled but no trained %s weights ship: "
                            "stage disabled (pass EnhanceConfig.weights to "
                            "force)", e.backend)
            else:
                if e.backend == "gtcrn":
                    kwargs = {"chunk_s": e.chunk_s, "overlap_s": e.overlap_s}
                elif e.backend == "demix-dialog":
                    kwargs = {}
                else:
                    kwargs = {"window_s": e.window_s, "hop_ratio": e.hop_ratio,
                              "batch_size": e.batch_size}
                self.enhance_fn = make_enhance_fn(
                    e.backend, weights=e.weights, device=self.device, **kwargs)
        if encoder is None and encode_fn is None:
            from ..models.port import load_speaker_encoder
            from ..utils.weights import ENCODER_PREFERENCE, prefer_weights

            path = prefer_weights(ENCODER_PREFERENCE)
            if path is None:
                raise FileNotFoundError("no shipped speaker encoder")
            encoder = load_speaker_encoder(path)
        if vad is None and vad_probs_fn is None:
            from ..models.vad import EnergyVad

            vad = EnergyVad(cfg.audio.sample_rate, cfg.vad.win_ms,
                            cfg.vad.hop_ms)
        # a module moves to this device; a sharded encoder
        # (``parallel.make_sharded_encode_fn``) keeps its replicas where its
        # mesh put them
        self.encoder = (encoder.to(self.device).eval()
                        if isinstance(encoder, torch.nn.Module) else encoder)
        self.vad = None if vad is None else vad.to(self.device).eval()
        self.vad_probs_fn = (self.vad.probs if vad_probs_fn is None
                             else self._on_device(vad_probs_fn))
        self._programs: dict = {}
        self._file_ids = itertools.count()   # the id of each file's stages
        self._last_snr_db: float | None = None
        self._last_floor_hf_frac = 1.0
        self._demix_fe = None
        self._demix_checked = False

    def _on_device(self, fn):
        """``fn`` with its result, a tensor or an array, as a float32
        tensor on this pipeline's device."""
        dev = self.device

        def call(x):
            out = fn(x)
            if not isinstance(out, torch.Tensor):
                out = torch.from_numpy(np.asarray(out))
            return out.to(dev, torch.float32)

        return call

    def encode_fn(self, wavs) -> torch.Tensor:
        """The per-utterance encoder: [B, T] waveforms (array or tensor) ->
        [B, D] float32 embeddings on this pipeline's device: the
        constructor's ``encode_fn`` when given, else the encoder's
        ``encode_batch`` (one log-mel launch for the batch on the card)."""
        with torch.inference_mode():
            wavs = torch.as_tensor(wavs, dtype=torch.float32).to(self.device)
            if self._encode is not None:
                return self._encode(wavs)
            return self.encoder.encode_batch(wavs)

    # ------------------------------------------------------------------ io --
    @staticmethod
    def _quantize_host(y: np.ndarray, t_pad: int) -> tuple[np.ndarray, float]:
        """Pad to whole chunks and quantize f32 -> int16 on the host, scaled
        to the signal's own peak (returned as ``scale``; the device dequant
        multiplies it back) so quiet or >1.0 sources keep 16-bit resolution
        and the absolute level is restored before loudness normalization.
        Halves the bytes of the host-to-device upload."""
        t = y.shape[-1]
        peak = float(np.max(np.abs(y))) if t else 0.0
        scale = peak if peak > 1e-6 else 1.0
        out = np.zeros(t_pad, np.int16)
        out[:t] = np.clip(y * (32767.0 / scale), -32768.0, 32767.0).astype(np.int16)
        return out, scale

    def _host_snr_db(self, x: np.ndarray) -> float:
        """10*log10(p95/p05) of 50 ms frame energies: the streamed path's
        noise probe, which gates the enhancement front-end, the refine
        splitting and the overlap detector."""
        frame = self._SNR_FRAME
        t = (x.shape[-1] // frame) * frame
        if t == 0:
            return float("inf")
        e = np.mean(np.square(x[:t].reshape(-1, frame)), axis=1)
        p5, p95 = np.percentile(e, [5.0, 95.0])
        if not np.isfinite(p95) or p95 <= 0.0:
            return float("inf")
        return 10.0 * float(np.log10(p95 / max(p5, 1e-12 * p95 + 1e-30)))

    # ------------------------------------------------------ streamed ingest --
    def _chunk_program(self, sr: int, u: int, m_l: int, m_r: int,
                       ov: bool = False):
        """(prev, cur, next, scale, n_valid) -> (probs, energy|None, grid,
        overlap-hard|None) over one core chunk of ``u`` samples with
        ``m_l``/``m_r`` samples of real neighbour context.  Plain eager
        PyTorch; cached by its full key.

        ``ov`` adds the overlap DETECTOR: 5 s windows every
        ``overlap.chunk_hop_s`` of the chunk's RAW waveform (dequantized,
        before gain, DC and pre-emphasis: the detector trained on raw
        audio) go through the segmentation net, and its hard slot decisions
        ride the one packed copy."""
        key = (sr, u, m_l, m_r, ov)
        if key in self._programs:
            return self._programs[key]
        count("program_builds")
        cfg = self.cfg
        acfg = cfg.audio
        seg = self._overlap_seg() if ov else None
        win5 = int(round(cfg.overlap.chunk_s * sr))
        stride5 = max(1, int(round(cfg.overlap.chunk_hop_s * sr)))
        wpsc = u // stride5
        hop_v = int(round(cfg.vad.hop_ms / 1000.0 * sr))
        grid_win = int(round(cfg.reseg.win_s * sr))
        grid_hop = int(round(cfg.reseg.hop_s * sr))
        wpc = u // grid_hop
        f0, f1 = m_l // hop_v, m_l // hop_v + u // hop_v
        want_energy = cfg.vad.energy_floor_db is not None
        vad, enc = self.vad, self.encoder
        # a neural VAD reads a log-mel; the energy VAD and a vad_probs_fn the
        # waveform.  The VAD and the ECAPA read the same log-mel when the
        # mels, 25 ms / 10 ms and the rate agree: computed once per chunk then
        neural = hasattr(vad, "probs_from_feats")
        on_card = self._on_card
        shared = neural and (vad.net.n_mels == enc.net.n_mels
                             and vad.win_ms == 25.0 and vad.hop_ms == 10.0
                             and vad.sample_rate == enc.sample_rate)

        def program(c_prev, c_cur, c_next, scale: float, n_valid: float):
            y3 = torch.cat([c_prev[-m_l:], c_cur, c_next[:m_r]])
            y3 = y3.float() * float(np.float32(scale) / np.float32(32767.0))
            hard = None
            if seg is not None:
                # the last window reaches win5 - stride5 samples into the
                # right margin.  A view: the log-mel kernel addresses the
                # rows by their stride (stride5 samples), so the windows
                # are read in place and never copied
                wins = (y3[m_l:m_l + (wpsc - 1) * stride5 + win5]
                        .unfold(0, win5, stride5))           # [wpsc, win5]
                hard = seg.hard_activities(wins)
            if acfg.target_lufs is not None:
                # loudness metered per chunk on its CORE samples
                lufs = integrated_loudness(y3[m_l:m_l + u], sr)
                gain = 10.0 ** ((acfg.target_lufs - lufs) / 20.0)
                gain = torch.where(lufs <= -199.0, torch.ones_like(gain), gain)
                y3 = torch.clamp(y3 * gain, -0.99, 0.99)
            if acfg.remove_dc:
                y3 = y3 - y3[m_l:m_l + u].sum() / max(n_valid, 1.0)
            if acfg.preemphasis is not None:
                y3 = preemphasis(y3, acfg.preemphasis)
            y3 = torch.clamp(y3, -0.99, 0.99)
            # u//hop + 1 frames per chunk: frame f1 (= frame 0 of the next
            # chunk's core) is dropped for interior chunks at pack time
            feats_e = fused_log_mel(y3, sample_rate=enc.sample_rate,
                                    n_mels=enc.net.n_mels)
            if shared:
                probs = vad.probs_from_feats(feats_e)
            elif neural:
                probs = vad.probs_from_feats(fused_log_mel(
                    y3, sample_rate=sr, n_mels=vad.net.n_mels,
                    win_ms=vad.win_ms, hop_ms=vad.hop_ms))
            elif vad is not None:
                probs = vad.probs(y3)
            else:
                probs = self.vad_probs_fn(y3[None])[0]
            probs = probs[f0:f1 + 1]
            energy = (frame_energy_db_chunk(y3, hop=hop_v, n_extra=1)[f0:f1 + 1]
                      if want_energy else None)
            with stage_timer(log, "encoder", device=on_card):
                grid = enc.encode_grid_feats(feats_e, wpc, m_l, grid_win, grid_hop)
            return probs, energy, grid, hard

        self._programs[key] = program
        return program

    def streaming_capable(self) -> bool:
        """True when the streamed ingest can run this config: the grid
        embedding mode with a streaming-trained encoder and
        ``grid_backend`` 'auto' or 'streaming' (the JAX package's rule;
        the chunk geometry is checked per call)."""
        return (self.cfg.embed.mode == "grid"
                and getattr(self.encoder, "streaming_trained", False)
                and self._streaming_grid_asked())

    def _streaming_grid_asked(self) -> bool:
        """``grid_backend='streaming'``, or 'auto' with a streaming-trained
        encoder: the JAX package's choice of grid, before the geometry."""
        backend = self.cfg.embed.grid_backend
        return backend == "streaming" or (
            backend == "auto" and getattr(self.encoder, "streaming_trained", False))

    def _grid_is_streaming(self, sr: int) -> bool:
        """The whole-file path's grid: the streaming trunk-shared grid when
        :meth:`_streaming_grid_asked`, the encoder has a trunk
        (``encode_grid_chunk``) and the grid aligns to the 10 ms mel hop
        (else a warning and the windowed grid, as in the JAX package);
        otherwise the windowed grid.  Unlike the streamed ingest, a forced
        'streaming' backend takes it with an ECAPA that is not
        streaming-trained, as in the JAX package."""
        cfg = self.cfg
        streaming = self._streaming_grid_asked()
        if streaming and not hasattr(self.encoder, "encode_grid_chunk"):
            log.warning("grid_backend=streaming needs an encoder with "
                        "encode_grid_chunk; falling back to windowed")
            streaming = False
        if streaming:
            mel_hop = sr * 10 // 1000
            if (int(round(cfg.reseg.win_s * sr)) % mel_hop
                    or int(round(cfg.reseg.hop_s * sr)) % mel_hop):
                log.warning("grid geometry win=%.3fs hop=%.3fs is not a multiple "
                            "of the 10 ms mel hop; streaming grid disabled, using "
                            "the windowed backend", cfg.reseg.win_s, cfg.reseg.hop_s)
                streaming = False
        return streaming

    def _geometry(self, sr: int) -> tuple[int, int, int, int, int] | None:
        """-> (u, m_l, m_r, grid_win, grid_hop), or None when the config's
        geometry cannot take the streamed path."""
        cfg = self.cfg
        mel_hop = sr * 10 // 1000
        grid_win = int(round(cfg.reseg.win_s * sr))
        grid_hop = int(round(cfg.reseg.hop_s * sr))
        hop_v = int(round(cfg.vad.hop_ms / 1000.0 * sr))
        u = int(self._PAD_BUCKET_S * sr)
        m_l = 4 * sr  # >= trunk receptive field + sliding-stat window
        m_l = -(-m_l // grid_hop) * grid_hop
        m_r = m_l + grid_win - grid_hop
        if (grid_win % mel_hop or grid_hop % mel_hop or u % grid_hop
                or u % hop_v or m_l % hop_v or u < m_r):
            return None
        return u, m_l, m_r, grid_win, grid_hop

    def _streamed_start(self, y: np.ndarray, sr: int) -> dict | None:
        """Dispatch phase: pinned-memory chunk uploads, one program per
        chunk, and the device-side pack into one flat tensor whose copy to
        pinned host memory is queued — nothing here waits for the device.
        None when the file takes the whole-file path before any work: the
        geometry cannot stream, or a scope forces the enhancement front-end.
        When the probe engages the front-end, the whole-file path's inputs
        instead: ``legacy_source`` and ``quantized`` (host int16 samples,
        their upload, scale, probe SNR)."""
        cfg = self.cfg
        dev = self.device
        if not self.streaming_capable():
            return None
        geo = self._geometry(sr)
        if geo is None:
            return None
        if self.enhance_fn is not None and cfg.enhance.scope != "auto":
            return None           # enhancement forced on: whole-file path
        u, m_l, m_r, grid_win, grid_hop = geo
        hop_v = int(round(cfg.vad.hop_ms / 1000.0 * sr))
        t = int(y.shape[-1])
        n_chunks = max(1, -(-t // u))
        with stage_timer(log, "ingest.quantize"):
            q, scale = self._quantize_host(np.asarray(y, np.float32), n_chunks * u)
        with stage_timer(log, "ingest.upload"):
            q_host = torch.from_numpy(q)
            if dev.type == "cuda":
                q_host = q_host.pin_memory()
            chunks = [q_host[i * u:(i + 1) * u].to(dev, non_blocking=True)
                      for i in range(n_chunks)]
            zero = torch.zeros(u, dtype=torch.int16, device=dev)
            count("h2d_bytes", q.nbytes)

        # host probe under the uploads: gates the enhancement front-end and
        # the noise-sensitive refine splitting
        with stage_timer(log, "ingest.probe"):
            x = q[:t].astype(np.float32) * (scale / 32767.0)
            self._last_snr_db = self._host_snr_db(x)
        if (self.enhance_fn is not None
                and self._last_snr_db < cfg.enhance.auto_snr_db):
            # enhancement engaged: the whole-file path goes on from the
            # quantized file, its uploads and the probe
            return {"legacy_source": y, "t": t, "sr": sr, "quantized": (
                q, torch.cat(chunks), scale, self._last_snr_db)}

        # overlap detector inside the chunk program: only when enabled, the
        # noise veto passes (the conversation-trained detector reads a babble
        # bed as overlap), the window grid divides the chunk, the last
        # window fits the right margin, and a checkpoint ships
        ocfg = cfg.overlap
        win5 = int(round(ocfg.chunk_s * sr))
        stride5 = max(1, int(round(ocfg.chunk_hop_s * sr)))
        snr = self._last_snr_db
        with stage_timer(log, "ingest.program"):
            ov = bool(ocfg.enabled
                      and (ocfg.min_snr_db is None or snr is None
                           or snr >= ocfg.min_snr_db)
                      and u % stride5 == 0 and win5 - stride5 <= m_r
                      and self._overlap_seg() is not None)
            program = self._chunk_program(sr, u, m_l, m_r, ov)
        want_energy = cfg.vad.energy_floor_db is not None
        probs, energy, grids, hards = [], [], [], []
        with torch.inference_mode():
            with stage_timer(log, "ingest.launch"):
                for i in range(n_chunks):
                    prev = chunks[i - 1] if i > 0 else zero
                    nxt = chunks[i + 1] if i + 1 < n_chunks else zero
                    p, e, g, h = program(prev, chunks[i], nxt, scale,
                                         float(min(u, t - i * u)))
                    last = i + 1 == n_chunks
                    probs.append(p if last else p[:-1])
                    if want_energy:
                        energy.append(e if last else e[:-1])
                    grids.append(g)
                    if ov:
                        hards.append(h)
                count("chunks", n_chunks)
            # ONE device-side pack + ONE device-to-host copy
            with stage_timer(log, "ingest.pack"):
                parts = [torch.cat(probs)]
                if want_energy:
                    parts.append(torch.cat(energy))
                grid = torch.cat(grids)
                parts.append(grid.reshape(-1).float())
                if ov:
                    hard = torch.cat(hards)                     # [windows, F, K]
                    parts.append(hard.reshape(-1).float())
                flat_dev = torch.cat(parts)
                if dev.type == "cuda":
                    flat = torch.empty(flat_dev.shape, dtype=flat_dev.dtype,
                                       pin_memory=True)
                    flat.copy_(flat_dev, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    flat, done = flat_dev, None
                count("d2h_bytes", flat_dev.nbytes)
        emb_dim = grid.shape[-1]
        st = {
            "flat": flat, "done": done, "q_host": q_host,
            "n_frames": t // hop_v + 1,
            "w_total": num_frames(t, grid_win, grid_hop, pad_tail=True),
            "n_probs": n_chunks * (u // hop_v) + 1,
            "want_energy": want_energy,
            "emb_dim": emb_dim,
            "grid_len": n_chunks * (u // grid_hop) * emb_dim,
            "starts_s": window_starts(t, sr, cfg.reseg.win_s, cfg.reseg.hop_s) / sr,
            "t": t, "sr": sr,
            "snr_db": self._last_snr_db,
            "ov": ov,
            "legacy_source": None,
        }
        if ov:
            st["ov_shape"] = tuple(hard.shape)
            # windows a whole-file detector would have scored: the rest
            # cover tail padding only
            st["ov_n"] = max(1, -(-max(t - win5, 0) // stride5) + 1)
        return st

    def _streamed_collect(self, st: dict):
        """Pull phase: wait for the one packed copy (on the CPU there is
        none to wait for), then host slicing."""
        with stage_timer(log, "collect"):
            with stage_timer(log, "collect.wait", wait=True):
                if st["done"] is not None:
                    st["done"].synchronize()
            flat = st["flat"].numpy()
            self._last_snr_db = st["snr_db"]
            n_frames, n_probs = st["n_frames"], st["n_probs"]
            probs = flat[:n_probs][:n_frames]
            off = n_probs
            energy = None
            if st["want_energy"]:
                energy = flat[off:off + n_probs][:n_frames]
                off += n_probs
            grid = (flat[off:off + st["grid_len"]]
                    .reshape(-1, st["emb_dim"])[:st["w_total"]])
            if st["ov"]:
                off += st["grid_len"]
                st["ov_acts"] = (flat[off:].reshape(st["ov_shape"])[:st["ov_n"]])
        return probs, energy, grid, st["starts_s"], st["t"] / st["sr"]

    # ---------------------------------------------------------------- main --
    def _host_array(self, source) -> np.ndarray:
        sr = self.cfg.audio.sample_rate
        if isinstance(source, np.ndarray):
            return source
        y, _ = read_audio(source, target_sr=sr, mono=True)
        return y

    @staticmethod
    def _prefetched(source) -> bool:
        return (isinstance(source, tuple) and len(source) == 4
                and isinstance(source[0], torch.Tensor))

    def prefetch(self, source) -> tuple[torch.Tensor, int, int, float]:
        """Host decode, quantize (padded to whole 60 s chunks) and an
        asynchronous upload from pinned memory, so a caller can overlap the
        next file's upload with this one's compute.  Returns (int16 device
        wave, valid samples, sr, scale); a call or :meth:`load` takes the
        tuple back (the whole-file path)."""
        y = np.asarray(self._host_array(source), np.float32)
        _, q_dev, scale = self._quantize_upload(y)
        return q_dev, int(y.shape[-1]), self.cfg.audio.sample_rate, scale

    def _quantize_upload(self, y: np.ndarray) -> tuple[np.ndarray, torch.Tensor, float]:
        """-> (host int16 padded to whole 60 s chunks, its asynchronous
        upload from pinned memory, scale)."""
        bucket = int(self._PAD_BUCKET_S * self.cfg.audio.sample_rate)
        t = y.shape[-1]
        q, scale = self._quantize_host(y, max(bucket, -(-t // bucket) * bucket))
        q_dev = torch.from_numpy(q)
        if self.device.type == "cuda":
            q_dev = q_dev.pin_memory()
        return q, q_dev.to(self.device, non_blocking=True), scale

    def load(self, source) -> tuple[torch.Tensor, int]:
        """The whole-file path's preprocessed wave on the device (the
        enhancer applied under scope ``full``) and its rate."""
        with torch.inference_mode():
            y, _, _ = self._load_waves(*self._whole_file_args(source))
        return y, self.cfg.audio.sample_rate

    def _whole_file_args(self, source):
        """(host wave or None, quantized or None, valid samples) of a source
        for :meth:`_load_waves`."""
        if self._prefetched(source):
            q_dev, t, _, scale = source
            return None, (None, q_dev, scale, None), t
        y = np.asarray(self._host_array(source), np.float32)
        return y, None, int(y.shape[-1])

    def stream_start(self, source) -> dict:
        """Dispatch a file's streamed ingest without waiting for the device;
        finish it with :meth:`stream_finish`.  A file that takes the
        whole-file path carries its waveform as ``legacy_source`` (or its
        prefetched upload as ``quantized``) and runs in
        :meth:`stream_finish`.  Each call starts a new file of this
        pipeline: its stages carry the file's id (``st["file_id"]``)."""
        self._last_snr_db = None
        sr = self.cfg.audio.sample_rate
        fid = next(self._file_ids)
        with file_scope(fid), stage_timer(log, "ingest"):
            if self._prefetched(source):
                _, quantized, t = self._whole_file_args(source)
                return {"legacy_source": None, "quantized": quantized, "t": t,
                        "sr": sr, "file_id": fid}
            y = np.asarray(self._host_array(source), np.float32)
            st = self._streamed_start(y, sr)
        if st is None:
            return {"legacy_source": y, "t": int(y.shape[-1]), "sr": sr,
                    "file_id": fid}
        st["file_id"] = fid
        if st["legacy_source"] is None:
            st["y_host"] = y    # for the standalone detect, when the fused
        return st               # detector could not arm

    def stream_finish(self, st: dict) -> DiarizationResult:
        """One packed pull + VAD post + clustering/segments."""
        with file_scope(st.get("file_id")):
            if st.get("legacy_source") is not None or "flat" not in st:
                return self._legacy_call(st["legacy_source"], st.get("quantized"),
                                         t=st["t"])
            cfg = self.cfg
            probs, energy_db, win_embs, starts_s, total_s = self._streamed_collect(st)
            with single_blas_thread():
                with stage_timer(log, "vad-post"):
                    speech = vad_segments_from_probs(probs, cfg.vad,
                                                     frame_energy_db=energy_db)
                if len(speech) == 0:
                    empty = SegmentArray.from_pairs([])
                    return DiarizationResult(empty, empty, 0)
                overlap_regions = None
                if st.get("ov_acts") is not None:
                    overlap_regions = regions_from_hard_acts(
                        st["ov_acts"], total_s, chunk_hop_s=cfg.overlap.chunk_hop_s,
                        min_on_s=cfg.overlap.min_on_s, min_gap_s=cfg.overlap.min_gap_s)
                res = self._segments_from_grid(
                    speech, probs, win_embs, starts_s, total_s, y=st.get("y_host"),
                    sr=st["sr"], overlap_regions=overlap_regions)
        if st.get("ov_acts") is not None:
            res.diagnostics["overlap_hard"] = st["ov_acts"]
            res.diagnostics["overlap_regions"] = overlap_regions
        res.diagnostics["route"] = "streamed"
        return res

    def __call__(self, source, collect_diagnostics: bool = False) -> DiarizationResult:
        """Diarize one file.  ``collect_diagnostics`` takes the whole-file
        path, as in the JAX package, and adds the window start times, the
        segment embeddings, the cluster labels and the segments after
        clustering, the conservative merge and frame reassignment
        (``stage_clustered`` / ``stage_merged`` / ``stage_reassigned``) to
        the diagnostics."""
        if collect_diagnostics:
            y_host, quantized, t = self._whole_file_args(source)
            return self._legacy_call(y_host, quantized, t=t, collect=True)
        return self.stream_finish(self.stream_start(source))

    # ------------------------------------------------------ whole-file path --
    def _floor_hf_frac(self, q: np.ndarray, t: int) -> float:
        """The noise floor's high-frequency fraction on the int16 samples:
        of the summed rfft power of the 50 ms frames (inside the ``t``
        valid samples) at or below the 10th energy percentile, the share
        above ``sr/8``.  Competing speech has a speech-shaped floor, under
        0.25; broadband noise about 0.5.  1.0 when undecidable."""
        frame = self._SNR_FRAME
        n = t // frame
        if n == 0:
            return 1.0
        fr = q[:n * frame].astype(np.float32).reshape(n, frame)
        e = np.mean(np.square(fr), axis=1)
        ps = np.sum(np.square(np.abs(np.fft.rfft(
            fr[e <= np.percentile(e, 10.0)], axis=1))), axis=0)
        hf = float(np.sum(ps[frame // 4:]) / (np.sum(ps) + 1e-30))
        return hf if np.isfinite(hf) and hf > 0.0 else 1.0

    def _demix_frontend(self):
        """The auto-route's separation front-end for a speech-shaped noise
        floor, built once per pipeline: ``[T]`` tensor -> the dialog stem
        rescaled to the input's RMS (over the whole padded vector).  It
        needs a separation-grade demixer: an HTDemucs ensemble of ``.th``
        checkpoints (``SDTPU_DEMUCS_CKPTS`` or ``weights/*.th``, which
        ``EnsembleDemixer`` prefers) or ``demix_mc.npz``; the shipped
        ``demix_synthetic.npz`` does not separate and is excluded.  With
        none, None and a warning: the route keeps the denoiser, as in the
        JAX package."""
        if not self._demix_checked:
            import os

            from ..utils import weights
            from .enhance import make_enhance_fn

            env = os.environ.get("SDTPU_DEMUCS_CKPTS", "")
            # as in the JAX package, a path in the variable counts even when
            # no such file exists; the ensemble then drops it and falls back
            # to the shipped npz (ROADMAP F9)
            has_ported = bool([p for p in env.split(":") if p]
                              or sorted(weights.WEIGHTS_ROOT.glob("*.th")))
            mc = weights.WEIGHTS_ROOT / "demix_mc.npz"
            if has_ported or mc.exists():
                raw_fe = make_enhance_fn("demix-dialog",
                                         weights=None if has_ported else str(mc),
                                         device=self.device)

                def fe(y: torch.Tensor) -> torch.Tensor:
                    out = raw_fe(y)
                    r_in = torch.sqrt(torch.mean(y * y) + 1e-12)
                    r_out = torch.sqrt(torch.mean(out * out) + 1e-12)
                    return out * (r_in / r_out)

                self._demix_fe = fe
            else:
                log.warning("enhance auto-route: no separation-grade demixer "
                            "available (ported .th or demix_mc.npz): keeping the "
                            "denoise backend for babble-like background")
            self._demix_checked = True
        return self._demix_fe

    def _preprocess(self, y: torch.Tensor, t: int, sr: int) -> torch.Tensor:
        """Whole-file loudness normalization, DC (the padded sum over the
        ``t`` valid samples), pre-emphasis, clip."""
        acfg = self.cfg.audio
        if acfg.target_lufs is not None:
            y = loudness_normalize(y, sr, acfg.target_lufs)
        if acfg.remove_dc:
            y = y - y.sum() / float(t)
        if acfg.preemphasis is not None:
            y = preemphasis(y, acfg.preemphasis)
        return torch.clamp(y, -0.99, 0.99)

    def _load_waves(self, y_host: np.ndarray | None, quantized=None,
                    t: int | None = None):
        """-> (wave, vad_wave, info) on the device, both ``t`` samples
        (``len(y_host)`` when given).  ``vad_wave`` is the denoised signal
        under scopes ``auto`` (when the probe engages) and ``vad``; under
        ``full`` both are.  ``quantized``: the streamed start's or
        :meth:`prefetch`'s (host int16 or None, its upload, scale, probe SNR
        or None), padded to whole 60 s chunks; else the file is quantized
        (and probed) here."""
        cfg = self.cfg
        sr = cfg.audio.sample_rate
        if y_host is not None:
            t = int(y_host.shape[-1])
        if quantized is None:
            with stage_timer(log, "load.quantize"):
                q, q_dev, scale = self._quantize_upload(y_host)
                count("h2d_bytes", q.nbytes)
            snr = None
        else:
            q, q_dev, scale, snr = quantized
        # the JAX package dequantizes with a float32 quotient here and with
        # a float64 one before the enhancer; both are kept
        y = q_dev.float() * float(np.float32(scale) / np.float32(32767.0))
        y_enh = None
        info = {"route": "legacy", "enhancer": None}
        ecfg = cfg.enhance
        if self.enhance_fn is not None:
            engage = True
            if ecfg.scope == "auto":
                if q is None:                   # a prefetched upload
                    with stage_timer(log, "load.host-copy", wait=True):
                        q = q_dev.cpu().numpy()
                if snr is None:
                    snr = self._host_snr_db(
                        q[:t].astype(np.float32) * (scale / 32767.0))
                with stage_timer(log, "load.floor-probe"):
                    hf = self._floor_hf_frac(q, t)
                self._last_snr_db, self._last_floor_hf_frac = snr, hf
                engage = snr < ecfg.auto_snr_db
                info.update(snr_db=snr, floor_hf_frac=hf)
                log.info("enhance auto-scope: est SNR %.1f dB (thr %.1f) -> %s",
                         snr, ecfg.auto_snr_db,
                         "denoise for VAD" if engage else "skip")
            if engage:
                y = q_dev.float() * float(np.float32(scale / 32767.0))
                fe = self.enhance_fn
                if (ecfg.scope == "auto" and ecfg.auto_route_demix
                        and ecfg.backend != "demix-dialog"
                        and self._last_floor_hf_frac < ecfg.babble_floor_hf_frac):
                    # a speech-shaped floor is competing speech, which a
                    # denoiser keeps: the file itself becomes the dialog stem
                    info["demix_requested"] = True
                    dfe = self._demix_frontend()
                    if dfe is not None:
                        with stage_timer(log, "demix"):
                            y = dfe(y)
                        fe = None
                        info["enhancer"] = "demix-dialog"
                if fe is not None:
                    with stage_timer(log, "enhance", device=self._on_card):
                        y_enh = fe(y)
                    info["enhancer"] = ecfg.backend
                    if ecfg.scope == "full":
                        y, y_enh = y_enh, None
        with stage_timer(log, "load.preprocess"):
            y = self._preprocess(y, t, sr)[:t]
            y_vad = y if y_enh is None else self._preprocess(y_enh, t, sr)[:t]
        return y, y_vad, info

    def vad_probs(self, y: torch.Tensor, sr: int) -> torch.Tensor:
        """VAD probabilities of a whole waveform over 15 s chunks."""
        hop = int(round(self.cfg.vad.hop_ms / 1000.0 * sr))
        return chunked_framewise(self.vad_probs_fn, y, sr, frame_hop=hop)

    def vad_frame_energy(self, y: torch.Tensor, sr: int) -> torch.Tensor:
        """Frame energy (dB) on the VAD's grid, chunked as the probs are."""
        hop = int(round(self.cfg.vad.hop_ms / 1000.0 * sr))
        return chunked_framewise(
            lambda rows: frame_energy_db_chunk(rows, hop=hop, n_extra=1),
            y, sr, frame_hop=hop)

    def _legacy_call(self, y_host: np.ndarray | None, quantized=None,
                     t: int | None = None, collect: bool = False) -> DiarizationResult:
        """The whole-file path: preprocess (and denoise), VAD and the
        streaming grid over the whole waveform, one copy to the host, then
        the host tail.  ``quantized`` and ``t``: as :meth:`_load_waves`
        takes them; ``collect``: the diagnostics of ``collect_diagnostics``.
        Its stages carry the file id of the ``stream_start`` it came from,
        else a new one."""
        fid = current_file()
        with file_scope(next(self._file_ids) if fid is None else fid):
            return self._whole_file(y_host, quantized, t, collect)

    def _whole_file(self, y_host, quantized, t, collect) -> DiarizationResult:
        """:meth:`_legacy_call`'s body, inside the file's scope."""
        cfg = self.cfg
        sr = cfg.audio.sample_rate
        streaming = self._grid_is_streaming(sr)
        want_energy = cfg.vad.energy_floor_db is not None
        with torch.inference_mode():
            with stage_timer(log, "load+preprocess"):
                y, y_vad, info = self._load_waves(y_host, quantized, t)
            with stage_timer(log, "dispatch"):
                with stage_timer(log, "dispatch.vad"):
                    probs = self.vad_probs(y_vad, sr)
                    parts = [probs]
                    if want_energy:
                        parts.append(self.vad_frame_energy(y_vad, sr))
                with (stage_timer(log, "dispatch.grid"),
                      stage_timer(log, "encoder", device=self._on_card)):
                    if streaming:
                        grid = embed_windows_streaming(self.encoder, y, sr,
                                                       cfg.reseg.win_s, cfg.reseg.hop_s)
                    else:
                        grid = embed_windows(self.encode_fn, y, sr,
                                             cfg.reseg.win_s, cfg.reseg.hop_s,
                                             batch=cfg.embed.batch_size)
                parts.append(grid.reshape(-1).float())
                flat_dev = torch.cat(parts)
                with stage_timer(log, "dispatch.copy", wait=True):
                    flat = flat_dev.cpu().numpy()    # one copy to the host
                    count("d2h_bytes", flat.nbytes)
        # the energy VAD has a few frames fewer than the frame energy
        n_p = probs.shape[0]
        n_e = parts[1].shape[0] if want_energy else 0
        probs_h = flat[:n_p]
        energy_h = flat[n_p:n_p + n_e] if want_energy else None
        grid_h = flat[n_p + n_e:].reshape(-1, grid.shape[-1])
        t = y.shape[-1]
        with single_blas_thread():
            with stage_timer(log, "vad-post"):
                speech = vad_segments_from_probs(probs_h, cfg.vad,
                                                 frame_energy_db=energy_h)
            if len(speech) == 0:
                empty = SegmentArray.from_pairs([])
                return DiarizationResult(empty, empty, 0,
                                         {**info, "vad_probs": probs_h})
            starts_s = window_starts(t, sr, cfg.reseg.win_s, cfg.reseg.hop_s) / sr
            res = self._segments_from_grid(speech, probs_h, grid_h, starts_s, t / sr,
                                           y=y, sr=sr, collect=collect)
        res.diagnostics.update(info)
        res.diagnostics["grid"] = "streaming" if streaming else "windowed"
        return res

    def _segments_from_grid(self, speech, probs, win_embs, starts_s, total_s,
                            y=None, sr=None, overlap_regions=None,
                            collect: bool = False) -> DiarizationResult:
        """SCD -> segment embeddings -> cluster -> refine -> conservative
        merge -> (frame reassignment) -> adjacent merge -> (overlap
        rescue), on the host.  ``y`` is what the bucketed embeddings cut
        their snippets from: as in the JAX package, the streamed path hands
        over the host array as read, the whole-file path the preprocessed
        device wave."""
        cfg = self.cfg
        grid_win_s = cfg.reseg.win_s
        grid_hop_s = cfg.reseg.hop_s
        speech2 = speech
        if cfg.scd.enabled:
            stride = max(1, int(round(cfg.scd.hop_ms / 1000.0 / grid_hop_s)))
            with stage_timer(log, "scd"):
                speech2 = scd_split(
                    speech, win_embs[::stride], starts_s[::stride], grid_win_s,
                    grid_hop_s * stride, z_threshold=cfg.scd.peak_z_threshold,
                    min_speech_s=cfg.scd.min_speech_ms / 1000.0)
        log.info("segments: vad=%d scd=%d", len(speech), len(speech2))

        with stage_timer(log, "segment-embeddings"):
            if cfg.embed.mode == "bucketed":
                seg_embs = embed_segments_bucketed(
                    self.encode_fn, y, sr, speech2,
                    min_duration_ms=cfg.embed.min_duration_ms,
                    pad_duration_ms=cfg.embed.pad_duration_ms,
                    batch=min(cfg.embed.batch_size, 32))
            else:
                seg_embs = segment_embeddings_from_grid(win_embs, starts_s,
                                                        grid_win_s, speech2)
            if cfg.embed.whiten and len(speech2) > 4:
                seg_embs = cluster_mod.whiten(torch.from_numpy(seg_embs)).numpy()
        with stage_timer(log, "cluster"):
            count("blas_threads", blas_threads())
            with stage_timer(log, f"cluster.{cfg.cluster.method}"):
                labels = self._cluster(seg_embs)
            refine_thr = cfg.cluster.refine_sub_cos
            if refine_thr is None:
                refine_thr = getattr(self.encoder, "refine_sub_cos", None)
            if refine_thr is None:
                from ..cluster.spectral import _SPLIT_MAX_CENT_COS

                refine_thr = _SPLIT_MAX_CENT_COS
            snr = self._last_snr_db
            snr_floor = cfg.cluster.refine_min_snr_db
            snr_ok = snr is None or snr_floor is None or snr >= snr_floor
            # the bisection was calibrated on spectral clustering; the other
            # methods keep their own labels
            if (cfg.cluster.refine_splits and refine_thr > 0
                    and len(speech2) > 1 and snr_ok
                    and cfg.cluster.method == "spectral"):
                with stage_timer(log, "cluster.refine"):
                    labels = cluster_mod.refine_labels_by_windows(
                        labels, speech2, win_embs, starts_s, grid_win_s,
                        cfg.cluster.max_speakers, sub_cos_thr=refine_thr,
                        seg_embs=seg_embs)
        speech2 = SegmentArray(speech2.starts, speech2.ends, labels)
        with stage_timer(log, "merge"):
            speech3, embs3 = conservative_merge(
                speech2, seg_embs, max_gap_s=cfg.merge.max_gap_s,
                max_turn_s=cfg.merge.max_turn_s, min_cos=cfg.merge.min_cos)
        speech4 = speech3
        if cfg.reseg.enabled:
            with stage_timer(log, "reassign"):
                speech4 = frame_reassign(
                    speech, speech3, embs3, win_embs, starts_s, grid_win_s,
                    total_s, hmm=cfg.reseg.hmm,
                    hmm_self_loop=cfg.reseg.hmm_self_loop,
                    adjacent_gap_s=cfg.reseg.adjacent_gap_s)
        final = merge_adjacent(speech4, cfg.merge.max_gap_s)
        if cfg.overlap.enabled and overlap_regions is not None:
            # the detector's decisions came out of the per-chunk program
            # (its gate was applied at dispatch)
            with stage_timer(log, "overlap-rescue"):
                final = self._overlap_rescue(
                    y, sr or cfg.audio.sample_rate, final, win_embs, starts_s,
                    grid_win_s, regions=overlap_regions)
        elif cfg.overlap.enabled and y is not None:
            snr = self._last_snr_db
            floor = cfg.overlap.min_snr_db
            if snr is not None and floor is not None and snr < floor:
                log.info("overlap-rescue: skipped (est SNR %.1f dB < %.1f "
                         "floor: detector untrustworthy under noise)",
                         snr, floor)
            else:
                with stage_timer(log, "overlap-rescue"):
                    final = self._overlap_rescue(
                        y, sr or cfg.audio.sample_rate, final, win_embs,
                        starts_s, grid_win_s)
        num_speakers = len({int(k) for k in final.spks if k >= 0})
        diagnostics = {"vad_probs": probs, "window_embeddings": win_embs}
        if collect:
            diagnostics.update(
                window_starts_s=starts_s, segment_embeddings=seg_embs,
                labels=labels, stage_clustered=speech2, stage_merged=speech3,
                stage_reassigned=speech4)
        return DiarizationResult(final, speech, num_speakers, diagnostics)

    # ------------------------------------------------------------ overlap --
    def _overlap_seg(self):
        """The overlap detector (a :class:`~..models.segmentation.
        SegmentationModel` on this pipeline's device), loaded at first use,
        or None when no checkpoint ships.  Shared by the per-chunk program
        and the standalone detect."""
        if not hasattr(self, "_overlap_model"):
            from ..utils.weights import SEGMENTATION_PREFERENCE, prefer_weights

            w = self.cfg.overlap.weights or prefer_weights(SEGMENTATION_PREFERENCE)
            if w is None:
                log.warning("overlap rescue: no segmentation checkpoint "
                            "ships: stage disabled")
                self._overlap_model = None
            else:
                from ..models.port import load_segmentation

                self._overlap_model = load_segmentation(w).to(self.device).eval()
        return self._overlap_model

    def _overlap_rescue(self, y, sr, final, win_embs, starts_s, win_s,
                        regions=None):
        """Second-speaker segments from the segmentation model's overlap
        detections (``segment/overlap.py``) on top of the flagship map.
        ``regions`` come from the per-chunk program; without them (the
        detector could not arm for the chunk geometry) the standalone
        detect scores the whole file once more."""
        ocfg = self.cfg.overlap
        if regions is None:
            seg = self._overlap_seg()
            if seg is None:
                return final
            regions = detect_overlap_regions(
                y, sr, make_seg_hard_fn(seg),
                chunk_s=ocfg.chunk_s, chunk_hop_s=ocfg.chunk_hop_s,
                min_on_s=ocfg.min_on_s, min_gap_s=ocfg.min_gap_s,
                device=self.device)
        return add_overlap_segments(
            final, regions, win_embs, np.asarray(starts_s), win_s,
            min_cos=ocfg.min_cos, max_overlap_frac=ocfg.max_overlap_frac)

    # ------------------------------------------------------------- cluster --
    def _cluster(self, embs: np.ndarray) -> np.ndarray:
        c = self.cfg.cluster
        n = embs.shape[0]
        if n <= 1:
            return np.zeros((n,), dtype=np.int32)
        if c.method == "spectral":
            labels = cluster_mod.spectral_cluster(
                embs, min_speakers=c.min_speakers, max_speakers=c.max_speakers,
                p_percentile=c.p_percentile)
        elif c.method == "ahc":
            labels = cluster_mod.ahc_cluster(
                embs, cos_threshold=c.cos_threshold,
                min_speakers=c.min_speakers, max_speakers=c.max_speakers)
        elif c.method == "hdbscan":
            labels = cluster_mod.hdbscan_cleaned(
                embs, min_cluster_size=c.min_cluster_size,
                centroid_cos_threshold=c.cos_threshold)
        else:
            labels = cluster_mod.hdbscan_two_stage(
                embs, min_cluster_size=c.min_cluster_size,
                centroid_cos_threshold=c.cos_threshold)
        if (labels < 0).all():
            # all noise: one speaker
            labels = np.zeros_like(labels)
        return labels.astype(np.int32)


def diarize(source, cfg: DiarizationConfig | None = None, **kwargs) -> list[Segment]:
    """One-call functional API mirroring ``anti_stick_diarize.diarize``:
    labeled segments of a path or an (array, sr) input; ``kwargs`` go to
    :class:`DiarizationPipeline` (``encode_fn``, ``vad_probs_fn``,
    ``enhance_fn``, ``encoder``, ``vad``, ``device``)."""
    return DiarizationPipeline(cfg, **kwargs)(source).to_segments()

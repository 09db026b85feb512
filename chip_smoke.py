"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card; exits nonzero without

Phases (any failure exits nonzero and prints no result line):
  1. CUDA present; the card's name and power limit (nvidia-smi); TF32 off
     for matrix products and convolutions; the native audio runtime builds
     and loads (its resampler timed on 600 s).
  2. Build every kernel of the main path from ``speech_diarization_tpu_torch/
     csrc`` (one nvcc per source, all started together).
  3. Each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (one 60 s chunk with its margins; for
     the log-mel also the overlap detector's batch of 24 five-second
     windows, read in place from the chunk; and the whole-file path's VAD
     batch of the 600 s noisy file, 43 rows of 15 s at a 14 s hop, read in
     place), in the working dtype: max abs and relative error against the
     stated tolerance, kernel / plain / library times (CUDA events) and the
     bound from bytes and operations.  The pooling also at the whole-file
     grid's short-file chunks (64 and 256 windows) on real trunk features.
     Then a correctness-only sweep of each kernel against its plain version
     at ragged shapes that reach every pad and mask (partial frame tiles,
     batches of one and five rows off the hop grid, overlapping rows at an
     odd stride, window rows below and off the 8-row tiles, grids that run
     past the end of the features), at the same tolerances.  Then the
     overlap detector (full-width ``segmentation_conv.npz``) on those 24
     windows: its hard decisions on the card against the CPU, and on the
     card with the kernel's features against the plain features.  Then the
     GTCRN denoiser (``gtcrn_mc.npz``) on a 10 s noisy file, card against
     CPU.
  4. The port's main path: ``DiarizationPipeline`` as ``bench.py`` runs it
     (spectral clustering, shipped ``vad_conv_mc.npz`` and
     ``ecapa_robust_stream.npz`` in bf16) on the bench's 60 s and 600 s
     generator draws, first with the overlap rescue off, then at the
     shipped default (on: the detector inside the per-chunk program): warm
     wall, timed wall (min of several), RTF, DER against the generator
     truth (bar: the JAX pipeline's DER on the same files on the CPU plus
     one point), and each kernel's launch count over the run (the log-mel
     once per chunk with the rescue off, twice with it on, one of them the
     batch; the pooling once).
  4b. The CLI's surface (frame reassignment on) on a 60 s held-out
     conversation with overlapped speech: the detector arms, the rescue
     adds second-speaker segments, and DER with it is no worse than
     without it.
  4c. The noisy-input route at the config's defaults (enhancement on, scope
     auto) on held-out draws in white noise at 10 dB (60 s, 600 s) and
     babble at 15 dB (60 s): the whole-file path through GTCRN is taken;
     warm and timed walls, GTCRN's device time (CUDA events around the
     enhancer), peak device memory, DER against the JAX pipeline's on the
     CPU plus one point, and the launch counts (the log-mel's ``[B, T]``
     entry once per VAD group of up to 64 15 s chunks; its ``[T]`` entry
     and the pooling once per grid chunk of up to 600 windows).
  4d. The other enhancement back-ends on the whole-file path
     (``EnhanceConfig(backend=...)``): ZipEnhancer (``zipenhancer_mc.npz``)
     on white10 60 s and 600 s and babble15 60 s, the demix-dialog
     separator (``demix_synthetic.npz``, host resampling 16 <-> 44.1 kHz) on
     babble15 60 s and white10 600 s: the route and enhancer, the launch
     counts as in 4c, the enhancer's span on the card's clock (events
     around it; the demixer's includes its host resampling), peak device
     memory, and DER against the JAX pipeline's on the CPU plus one point
     (ZipEnhancer at 600 s: no bar, the JAX run is too long for the CPU).
     Before it, in phase 3: ZipEnhancer card vs CPU on four 2 s windows,
     one 64-window batch (device time, peak memory, achieved FLOP/s
     against the FLOPs of its products), and the demixer card vs CPU on one
     10 s stereo chunk at the shipped geometry (24/4/1) and at the
     constructor's (48/5/2, seeded weights), each also timed on the 80
     chunks of a 600 s file, with the host resampling of that file timed
     both ways.
  4e. The other encoders, VADs and clustering methods on the 60 s bench
     draw (overlap on), each within one point of the JAX pipeline's DER on
     the CPU, either way (``torch_port_der_bar.py --encoders``), with its
     route and exact launch counts by kernel, form and shape:
     ``ecapa_synthetic_full_stream.npz`` (streamed; K1 at A 128, K2 at 80
     mels; and forced onto the windowed grid, K2's windowed batch at 80
     mels) and ``ecapa_proto_small.npz`` (K1 at A 32), ``ecapa_synthetic.npz``
     on the windowed grid (K2's ``[B, T]`` entry on batches of 512
     overlapping 2 s windows) with the GRU VAD and with the energy VAD, and
     AHC and HDBSCAN clustering on the default encoder; the windowed grid
     also on the 600 s draw (launches per 600 s).  Phase 3
     holds K1 at A 32 / CC 384 and A 128 / CC 1536 on a 60 s chunk and K2 at
     80 mels on the chunk and on the windowed batch at 40 and 80 mels.
  4f. Held-out file 0 (seed 1000) of each of ``eval_heldout.py``'s eight
     domains at the CLI's defaults: DER (collar 0.25 s) within one point of
     the JAX pipeline's on the CPU, either way (``--heldout --cli``).
  4g. The corpus worker on three 60 s draws, the second in white noise at
     10 dB (the whole-file path): every file's segments equal its lone
     call's and the report has no errors.
  4h. The segmentation engine (``segmentation_diarize``) at its defaults
     (``segmentation_conv.npz``, the bf16 encoder, spectral clustering) on
     the 60 s and 600 s bench draws and held-out overlap file 0, and with
     ``segmentation_ow3.npz`` (cuDNN BiGRUs) on the 60 s draw: warm and
     timed walls, peak device memory, K2 launches by shape (one ``[B, T]``
     launch for all chunks of a file, 5 s every 0.625 s read in place; the
     1 s / 0.1 s window grid in batches of 512), DER within one point of
     the JAX CPU bar either way (``torch_port_der_bar.py --engine``); both
     nets' hard decisions on the card against the CPU on the 60 s draw's 89
     chunks.  Phase 3 holds K2 at the engine's chunks ([89, 80000] and
     [953, 80000] at a row stride of 10,000), its grid ([512, 16000] at
     1,600) and the bucketed snippets ([32, 8000 * 2^k], k = 0..5).
  4i. ``EmbedConfig(mode='bucketed')`` on the 60 s bench draw (the
     whole-file path): DER within one point of ``--bucketed``'s bar, K2
     launches by bucket; and on the 600 s draw for its launches per 600 s.
  4j. ``run_batch`` at ``Diarizer()``'s defaults with each engine on a
     temporary directory of two 60 s WAVs: RTTMs and stem WAVs written,
     RTTM lines equal to the JAX CPU bars' to the frame
     (``scripts/torch_port_batch_bars.json``, from ``--batch``), DER within
     one point, a second run and the CLI's ``batch`` skip both files; then
     ``diagnose`` (``save_plots=False``: the card's machine has no
     matplotlib) on one of them at the CLI's defaults.
  4k. The encoders that ship no checkpoint, at their published widths on
     the seed-0 draw of ``models.registry.seeded_state_dict``: ERes2NetV2
     written as ``.onnx`` (the port's own writer), CAM++ as ``.pt`` under
     ``state_dict`` and a SpeechBrain-format ECAPA as
     ``embedding_model.ckpt``, each loaded through ``make_encoder_model``
     and passed to the CLI's ``diarize`` on the card (with the trainer's
     ``ecapa_synthetic.npz`` too: each writes its RTTM).
     Card against CPU on 8 windows of 2 s (TF32 flags printed); the bench
     configuration (overlap on) on the 60 s bench draw with each, on the
     windowed grid: min-of-3 wall after a warm call, the encoder's span on
     the card's clock, peak device memory above the resident set, K2
     launches by shape (the grid's 512 + 69 windows at 80 mels: 2), DER
     within one point of the JAX CPU bar either way
     (``torch_port_der_bar.py --encoders``); then ERes2NetV2 once on the
     600 s draw: wall, device busy share and time by kernel
     (``torch.profiler``), the encoder's span beside the float32 bound of
     its convolutions and linears, peak memory, stage walls.
  4l. The published enhancer graphs and their importers on seeded weights:
     three full-width HTDemucs packages (``{kwargs, state}`` .th, seeds 0,
     1, 2), a ModelScope-style ZipEnhancerRef ``pytorch_model.bin`` and
     ``gtcrn_mc.npz`` as a DNS3-style tar, written to a temporary directory.
     HTDemucs on one 10 s stereo chunk and ZipEnhancerRef on four 2 s
     windows, card against CPU (bars ``HTDEMUCS_TOL_REL`` /
     ``ZIPREF_TOL_REL``, TF32 flags printed); GTCRN from the tar equal to
     the npz's output; the HTDemucs ensemble on the 600 s file's 80 chunks
     and ZipEnhancerRef on one 64-window batch and on the 400 windows of
     600 s, each on the card's clock beside its float32 bound (operations
     counted from the shapes, ``graph_flops``) and peak memory; the routes
     with their walls, launches by shape and DER within one point of the
     JAX CPU bars either way (``torch_port_der_bar.py --published``):
     ``EnhanceConfig(backend='zipenhancer-ref')`` on white10 60 s,
     ``backend='demix-dialog'`` and the default config's auto-route (which
     must take the demixer) with ``SDTPU_DEMUCS_CKPTS`` naming the .th files
     on babble15 60 s; both graphs once on white10 600 s (wall, busy share
     and top kernels from ``torch.profiler``); the CLI's ``enhance
     --backend zipenhancer-ref --weights pytorch_model.bin``, ``enhance
     --backend gtcrn --weights model.tar`` and ``demix`` on a 10 s WAV.
  5. Reference agreement on small inputs: the same pipeline (float32
     encoder) on the card and on the CPU (plain versions) over a 25 s file
     cut into three 10 s chunks, with the rescue off; the windowed grid
     (float32 ``ecapa_synthetic.npz``, energy VAD) on the same file, window
     embeddings compared; with rescue and
     reassignment on over a 25 s held-out file, where the detector's hard
     decisions, the overlap regions and the final segments are compared;
     and over a 25 s file in white noise at 10 dB (the whole-file path
     through GTCRN).
  6. Training (``speech_diarization_tpu_torch/train``): the recipes that made
     the shipped main-path weights, at the shipped widths, warm-started from
     them: the conv VAD (8 x 4 s), the proto encoder (12 speakers x 4
     utterances x 3 s, windows of 1 s at a hop of 0.5 s, the decomposed
     head), the powerset detector (8 x 5 s), GTCRN (8 x 2 s) and
     ``make_ecapa_train_step`` (16 x 2 s, train-mode BN).  For each: step 1
     on the card against the CPU (loss, flattened gradient: bars
     ``TRAIN_*``); ten steps after a warm-up with the median step time on
     CUDA events beside its float32 bound (3 x the forward's operations),
     peak memory, busy share, K2's launches a step by shape (one; none for
     GTCRN; K1 never) and the loss curve; the export after 0 steps equal to
     the shipped npz, and in the pipeline equal to the shipped file's
     segments (60 s bench draw; GTCRN on a white10 60 s draw); a
     checkpoint after step 5 restored gives step 6's loss and leaves
     exactly.  K2 at
     each training batch against its plain version and ``torch.stft``.
  7. The single-card public surface (``surface_phase``): every exported
     name imports; the CLI's ``diarize`` on a ``.flac`` decoded by stub
     ``ffmpeg`` / ``ffprobe`` (the bench 60 s draw; RTTM equal to the
     ``.wav`` run's); the cumsum sliding mean on the card against the
     banded form (``win`` 1025) and the CPU (1201, 2001) on 6,400 frames
     of log-mel and trunk activations, and the trunk with ``se_win=1201``
     card vs CPU (bars ``SLIDING_TOL_REL``, ``TRUNK_TOL_REL``); bench
     milestones 3.5 (the embed chunk's roofline) and 5 (K2 against the
     plain log-mel at ``[512, 16000]``); the web UI's slider config on the
     tone conversation, card vs CPU segments; ``Profiler.trace`` around a
     60 s call naming both kernels; the JAX call forms of ROADMAP F27 card
     vs CPU on the 60 s bench draw (``call_forms_step``): the uncentred
     log-mel, the conv VAD through ``chunked_framewise(chunk_s=10.0,
     overlap_s=0.5, group=2)`` (K2 at ``[2, 160000]`` rows 152,000 apart,
     first against its plain version) and the streaming grid at
     ``margin_s=2.0``.  Each run's K1 and K2 launches are counted
     (``launches_surface``).
  8. Scale (``parallel_phase``), on virtual meshes of the one card: the
     sharded encoder at dp 2, dp 4 and dp 2 x tp 2 against one device on
     the windowed grid's 512 windows (one K2 launch a shard); the corpus's
     sharded route on one 60 s and one 600 s file over two devices (segments
     equal to the single-device windowed grid, DER against the JAX bar of
     ``torch_port_der_bar.py --sharded``, walls); bench milestone 4 (K1 on
     each dp replica against the decomposed head); the ECAPA step on dp 2 x
     tp 2 and the GTCRN step on dp 2 against one device (bars ``TRAIN_*``,
     step medians); ``dryrun_multichip(2)`` and ``(4)``.  K1 and K2
     launches over the phase (``launches_parallel``).
  9. The evaluation and calibration tools (``tools_phase``): K2 on the
     probe's default batch ``[96, 32000]`` (80 mels) and K1 at its grid
     (A 128, ``win_f`` 101, ``hop_f`` 50) against their plain versions; then
     each ``scripts/torch_*.py`` tool's function at a small size on the card
     and with ``device='cpu'``: the RTTM selftest on one 60 s pair, the
     synthetic table on one tone file, the tail on seeds 2000-2001, the
     calibration on one 60 s file each of 2 and 3 speakers, the VAD and the
     detector on one 60 s file in two domains, the segmentation frame eval
     on one batch of 8 and its pipeline eval on one 30 s file, the probe at
     its defaults, GTCRN's SI-SNR on a batch of 4 and the grid backends on
     one 60 s file.  Each card result within ``TOOL_BARS`` of the CPU's;
     walls, launches by kernel and by shape (``launches_tools``).
Then a line with the walls of this slice's routes and of the whole run,
one JSON line listing the kernels, the card's nvidia-smi line, and the
result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SR = 16000
T_START = time.perf_counter()
sys.path.insert(0, str(HERE))
# the H100's peaks, the bound from bytes and operations, the kernels'
# analytic work and the card's clock live in the port: its bench uses them too
from speech_diarization_tpu_torch.ops.cost import (  # noqa: E402
    PEAK_FLOPS, asp_grid_work, bound, fused_log_mel_work,
)
from speech_diarization_tpu_torch.utils.profiling import cuda_time_ms  # noqa: E402

# DER (%) of the JAX reference on the CPU on the bench draws, overlap rescue
# off and on (scripts/torch_port_der_bar.py); the port must stay within one
# point.
JAX_CPU_DER_PCT = {False: {60: 0.0, 600: 0.6243},
                   True: {60: 0.0, 600: 0.6243}}
# the same at the config's defaults on the noisy held-out draws (noise kind,
# SNR dB, seconds), whole-file path through GTCRN (--noisy of that script)
JAX_CPU_DER_PCT_NOISY = {("white", 10.0, 60): 0.5717,
                         ("white", 10.0, 600): 0.5601,
                         ("babble", 15.0, 60): 6.0246}
# the same with the other enhancement back-ends (--noisy --enhance of that
# script); None: no bar (the JAX ZipEnhancer on 600 s is too long for the
# CPU), DER printed beside the GTCRN route's.  On the babble draw the
# shipped separator's dialog stem lies below the loudness meter's gate: the
# VAD hears silence in both packages and finds no speech (100 %)
# the same on the 60 s bench draw (overlap on) with the other shipped
# encoders, VADs and clustering methods (--encoders of that script): the
# streaming encoders at attention widths 128 and 32, the full-width one on
# the windowed grid (80 mels), the windowed grid of ecapa_synthetic.npz (not
# streaming-trained) with the GRU VAD and with the energy VAD, and the
# default encoder with AHC and HDBSCAN clustering
JAX_CPU_DER_PCT_OPTIONS = {"full_stream": 0.0, "full_stream_windowed": 1.3439,
                           "proto_small": 0.0, "windowed_gru": 33.5964,
                           "windowed_energy": 93.2381, "ahc": 0.0,
                           "hdbscan": 0.0}
# held-out file 0 (seed 1000) of each domain at the CLI's defaults
# (--heldout --cli of that script)
JAX_CPU_DER_PCT_HELDOUT_CLI = {
    "indomain": 1.9551, "heldout-dry": 1.5989, "heldout-reverb3": 2.2841,
    "heldout-reverb6": 2.307, "heldout-babble15": 4.9338,
    "heldout-babble5": 6.2586, "heldout-white10": 1.9187,
    "heldout-overlap": 6.9316}
# the segmentation engine at its defaults (spectral on the JAX package's
# numpy path, the bf16 encoder) on the bench draws and held-out overlap file
# 0 with segmentation_conv.npz, and on the 60 s draw with
# segmentation_ow3.npz (--engine of that script); the bench configuration
# with bucketed segment embeddings on the 60 s draw (--bucketed)
JAX_CPU_DER_PCT_ENGINE = {"conv_bench_60s": 32.2526, "conv_bench_600s": 33.509,
                          "conv_heldout_overlap_0": 11.0409, "ow3_bench_60s": 32.5939}
JAX_CPU_DER_PCT_BUCKETED = 1.3439
ENCODERS = {"full_stream": "ecapa_synthetic_full_stream.npz",
            "proto_small": "ecapa_proto_small.npz",
            "windowed": "ecapa_synthetic.npz"}
JAX_CPU_DER_PCT_ENHANCED = {("zipenhancer", "white", 10.0, 60): 4.2436,
                            ("zipenhancer", "white", 10.0, 600): None,
                            ("zipenhancer", "babble", 15.0, 60): 13.3245,
                            ("demix-dialog", "babble", 15.0, 60): 100.0,
                            ("demix-dialog", "white", 10.0, 600): 2.8824}
DER_SLACK_PCT = 1.0


# tolerances of kernel vs plain version on the card (max abs error over the
# output, relative to the plain output's largest magnitude).  Both sides
# accumulate in float32 in another order; K1 also rounds its tanh
# activations to bf16, where a one-ulp difference in tanh can flip a bf16
# rounding.
TOL_REL = {"fused_log_mel": 1e-4, "asp_grid_stats": 2e-3}
# the kernels of the diarizer's own path; K3 (resample_poly) runs on the
# demix-dialog route alone
K12 = ("asp_grid_stats", "fused_log_mel")
# GTCRN on the card against the CPU (max abs error over the enhanced
# waveform, relative to its peak): cuDNN's GRUs and convolutions sum in
# another order, over ten recurrences of 626 steps on 10 s
GTCRN_TOL_REL = 1e-3
# ZipEnhancer and the demixer on the card against the CPU, the same way:
# cuDNN / cuBLAS and the attention kernel sum in another order, and the
# mask's power 1/0.3 amplifies a relative error about 3.3 times
ZIP_TOL_REL = 1e-3
DEMIX_TOL_REL = 1e-3
# least share of equal hard decisions of the overlap detector between two
# ways of computing them (an argmax over 8 logits flips on near-ties)
HARD_AGREE = 0.999
# the speaker encoders on the card against the CPU (max abs error over the
# embeddings, relative to their largest magnitude; least cosine), TF32 off,
# for the net alone on the same features and for all of encode_batch (K2's
# log-mel on the card).  cuDNN's float32 convolutions sum in another order
# than the CPU's.  ERes2NetV2 on the seed-0 draw amplifies that: on the
# CPU a perturbation of its features by one part in 1e7 moves its
# embeddings by 2.4e-4 of their peak (the AFF gates; 2.1e-3 at 1e-6), and
# the card's net differs by 2.0e-3 (cos 0.9999989)
ENC_TOL_REL = {"eres2netv2": 5e-3, "campp": 1e-4, "ecapa_speechbrain": 1e-4}
ENC_COS = 0.99999
# DER (%) of the JAX reference on the CPU on the 60 s bench draw (overlap
# on) with the encoders that ship no checkpoint, at their published widths
# on the seed-0 draw of models.registry.seeded_state_dict, float32, the
# windowed grid (--encoders of scripts/torch_port_der_bar.py).  Random
# weights: each finds one speaker
JAX_CPU_DER_PCT_SEEDED = {"eres2netv2": 59.215, "campp": 59.215,
                          "ecapa_speechbrain": 59.215}
# the published enhancer graphs on the card against the CPU (max abs error
# over the output, relative to its peak), TF32 off: HTDemucs on one 10 s
# stereo chunk, ZipEnhancerRef on four 2 s windows, both on seeded weights
HTDEMUCS_TOL_REL = 1e-3
ZIPREF_TOL_REL = 1e-3
# DER (%) of the JAX reference on the CPU with the published graphs on the
# seeded draws phase 4l writes (--published of torch_port_der_bar.py): the
# ZipEnhancerRef route (the JAX graph given the port's exact zeros in its
# input spectrum, ROADMAP F18) on white10 60 s, EnhanceConfig(backend=
# 'demix-dialog') and the default config's auto-route with the HTDemucs
# ensemble (seeds 0, 1, 2) on babble15 60 s
JAX_CPU_DER_PCT_PUBLISHED = {"zipenhancer-ref": 0.5717, "demix-dialog": 8.3333,
                             "auto": 8.8171}


def log(msg: str) -> None:
    print(msg, flush=True)


def k2_measure(y, n_unique: int, n_mels: int = 40) -> dict:
    """K2 at ``n_mels`` on ``y`` ([T] or [B, T], possibly a view with
    overlapping rows of ``n_unique`` distinct samples) against its plain
    version, with kernel, plain and library times and the bound."""
    import torch

    from speech_diarization_tpu_torch.dsp.mel import fused_log_mel, log_mel_spectrogram

    n_fft = 400
    out = fused_log_mel(y, n_mels=n_mels)
    ref = log_mel_spectrogram(y, n_mels=n_mels).reshape(out.shape)
    torch.cuda.synchronize()
    n_frames = out.numel() // n_mels
    err = (out - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    tol = TOL_REL["fused_log_mel"] * ref_max
    # the function's work (ops/cost.py): bytes once, the fold's least
    # operations with the DFT as three TF32 products
    work = fused_log_mel_work(n_frames, n_mels, n_unique, n_fft, SR)
    b_ms, b_by = bound(work["bytes"], work["ops"])
    win = torch.hann_window(n_fft, periodic=True, device=y.device)
    return {
        "shape": list(y.shape), "row_stride": y.stride(0) if y.ndim == 2 else None,
        "n_mels": n_mels, "frames": n_frames,
        "max_abs_err": err, "tol": tol, "ref_max": ref_max,
        "ms": cuda_time_ms(lambda: fused_log_mel(y, n_mels=n_mels)),
        "plain_ms": cuda_time_ms(lambda: log_mel_spectrogram(y, n_mels=n_mels)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_time_ms(lambda: torch.stft(
            y, n_fft, 160, window=win, center=True, pad_mode="reflect",
            return_complex=True)),
    }


def k1_measure(net, x, n_w: int, first_f: int, hop_f: int = 10,
               win_f: int = 201) -> dict:
    """K1 on the trunk features ``x`` [CC, T_f] of ``net`` over a grid of
    ``n_w`` windows against its plain version, with kernel and plain times
    and the bound.  The bound counts the net's own attention width (the
    kernel's zero padding to a multiple of 64 is not the function's work)."""
    import torch

    from speech_diarization_tpu_torch.models.ecapa import (
        _asp_grid_stats_plain, asp_grid_stats,
    )

    args = net.k1_inputs(x, first_f, hop_f, win_f, n_w)
    out = asp_grid_stats(*args)
    ref = _asp_grid_stats_plain(*args)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    cc, a_dim = x.shape[0], net.att_channels
    work = asp_grid_work(cc, a_dim, hop_f, win_f, n_w)
    b_ms, b_by = bound(work["bytes"], work["ops"])
    return {
        "a_dim": a_dim, "a_padded": args[2].shape[0], "cc": cc, "windows": n_w,
        "max_abs_err": err, "tol": TOL_REL["asp_grid_stats"] * ref_max,
        "ref_max": ref_max,
        "ms": cuda_time_ms(lambda: asp_grid_stats(*args)),
        "plain_ms": cuda_time_ms(lambda: _asp_grid_stats_plain(*args), 5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def conv_flops(net, n_frames: int, n_mels: int) -> int:
    """Operations of ``net``'s convolutions and linears on one window of
    ``n_frames`` x ``n_mels`` features (two per multiply-add), counted from
    the output shapes of one forward."""
    import torch

    total = [0]

    def hook(mod, _inp, out):
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features
        else:
            total[0] += (2 * out.numel() * (mod.in_channels // mod.groups)
                         * int(np.prod(mod.kernel_size)))

    kinds = (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear)
    handles = [m.register_forward_hook(hook) for m in net.modules()
               if isinstance(m, kinds)]
    try:
        with torch.inference_mode():
            net(torch.zeros(1, n_frames, n_mels, device=next(net.parameters()).device))
    finally:
        for h in handles:
            h.remove()
    return total[0]


def kernel_times_us(prof) -> dict[str, float]:
    """Device time (us) by kernel of a ``torch.profiler`` run (the device
    entries only: a CPU op also carries its kernels' time)."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        v = getattr(e, "self_device_time_total", None)
        if v is None:
            v = getattr(e, "self_cuda_time_total", 0.0)
        if v and v > 0:
            out[e.key] = float(v)
    return out


def zipenhancer_flops(n_windows: int, samples: int = 32000, n_fft: int = 400,
                      hop: int = 100, c: int = 64, blocks: int = 4) -> dict:
    """Multiply-adds (x2) of ZipEnhancer's products on ``n_windows``
    windows, by kind: the linears (qkv, proj, fc1, fc2 of both paths), the
    two attention products of both paths, the convolutions (encoder,
    both transposed decoders, the 1x1 heads) and the STFT / iSTFT bases."""
    t = 1 + samples // hop                     # 321 frames
    f_in = n_fft // 2 + 1                      # 201 bins
    f = (f_in + 2 - 3) // 2 + 1                # 101 bins after the encoder
    tokens = t * f
    linears = blocks * 2 * 2 * tokens * c * (3 * c + c + 2 * c + 2 * c)
    attention = blocks * 2 * 2 * c * (f * t * t + t * f * f)
    convs = (2 * t * f_in * c * 2 * 9 + 2 * tokens * c * c * 3
             + 2 * 2 * tokens * c * c * 3 + 2 * 3 * t * f_in * c)
    stft = 2 * 2 * t * n_fft * 2 * f_in
    out = {"linears": linears, "attention": attention, "convs": convs, "stft": stft}
    return {k: float(v * n_windows) for k, v in out.items()}


def seeded_demixer(seed: int = 0):
    """The demixer at its constructor's geometry (48 channels, depth 5, two
    bottleneck blocks) with normal weights from a seeded generator, scaled
    by sqrt(2 / fan-in) over the last two dimensions (the decoder's
    transposed convolutions x0.1 more, as in the JAX package's init),
    biases zero."""
    import torch

    from speech_diarization_tpu_torch.models.demix import DialogDemixer

    net = DialogDemixer()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.ndim == 3:
                w = torch.randn(p.shape, generator=g) * (2.0 / (p.shape[1] * p.shape[2])) ** 0.5
                p.copy_(w * (0.1 if name.startswith("dec") and "glu" not in name else 1.0))
    return net.eval()


def agreement(a, b) -> float:
    """Share of equal entries of two arrays or tensors of hard decisions."""
    import torch

    a, b = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (a, b))
    if a.shape != b.shape:
        raise AssertionError(f"hard decisions of shapes {a.shape} and {b.shape}")
    return float((a == b).mean())


def ragged_sweep(enc, dev) -> None:
    """Each kernel against its plain version at shapes that reach every pad
    and mask; raises on the first miss of the main-path tolerances."""
    import torch

    from speech_diarization_tpu_torch.dsp.mel import (
        _log_mel_1d, fused_log_mel, log_mel_spectrogram,
    )
    from speech_diarization_tpu_torch.models.ecapa import (
        _asp_grid_stats_plain, asp_grid_stats,
    )

    def check(name, what, out, ref):
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = TOL_REL[name] * ref.abs().max().item()
        if out.shape != ref.shape or not err <= tol:
            raise AssertionError(f"{name} at {what}: shape {tuple(out.shape)} vs "
                                 f"{tuple(ref.shape)}, max abs err {err:.3e} "
                                 f"above {tol:.3e}")
        return err / tol

    g = torch.Generator().manual_seed(7)
    worst = {"fused_log_mel": 0.0, "asp_grid_stats": 0.0}
    # K2: exactly one 64-frame tile, one frame more, a length off the hop
    # grid, and the shortest input the reflect pad takes
    for t in (63 * 160, 64 * 160, 8000 + 37, 10 * SR + 77, 201):
        # a loud tone over noise 30 dB below it: the quiet mel bands see
        # the loud bins' rounding error
        n = torch.arange(t, dtype=torch.float32)
        y = (0.6 * torch.sin(2 * torch.pi * 440.0 / SR * n)
             + 2e-2 * torch.randn(t, generator=g)).to(dev)
        worst["fused_log_mel"] = max(worst["fused_log_mel"], check(
            "fused_log_mel", f"T={t}", fused_log_mel(y, n_mels=40),
            _log_mel_1d(y, n_mels=40)))
    # K2 on batches: one row, five contiguous rows off the hop grid, five
    # overlapping rows read in place at an odd stride (rows not 16-byte
    # aligned against each other), and rows one tile long
    n_batches = 0
    for b, t, stride in ((1, 8000 + 37, None), (5, 8000 + 37, None),
                         (5, 8000 + 37, 3001), (3, 64 * 160, 5000),
                         (5, 201, None)):
        n = torch.arange(t + 4 * (stride or t), dtype=torch.float32)
        sig = (0.6 * torch.sin(2 * torch.pi * 440.0 / SR * n)
               + 2e-2 * torch.randn(n.numel(), generator=g)).to(dev)
        yb = (sig[:b * t].reshape(b, t) if stride is None
              else sig[:(b - 1) * stride + t].unfold(0, t, stride))
        worst["fused_log_mel"] = max(worst["fused_log_mel"], check(
            "fused_log_mel", f"B={b} T={t} row stride {yb.stride(0)}",
            fused_log_mel(yb, n_mels=40), log_mel_spectrogram(yb, n_mels=40)))
        n_batches += 1
    # K1: window rows on, below and off the 8-row tiles (301 and 450 are
    # walked in two and three chunks of 208 rows), odd hops, odd first rows
    # and T_f, and one grid per shape whose last rows run past T_f
    n_grids = 0
    for n_w in (1, 7, 100):
        for win_f in (201, 64, 37, 301, 450):
            for hop_f in (10, 3):
                first_f = 3 + n_w % 5
                need = first_f + (n_w - 1) * hop_f + win_f
                x = torch.randn(768, need + 5, generator=g).to(dev).to(torch.bfloat16)
                args = enc.net.k1_inputs(x, first_f, hop_f, win_f, n_w)
                for cut in (0, 9):       # cut: the grid overruns T_f by 4 rows
                    a = (x[:, :x.shape[1] - cut].contiguous(), *args[1:])
                    worst["asp_grid_stats"] = max(worst["asp_grid_stats"], check(
                        "asp_grid_stats",
                        f"W={n_w} win_f={win_f} hop_f={hop_f} T_f={a[0].shape[1]}",
                        asp_grid_stats(*a), _asp_grid_stats_plain(*a)))
                    n_grids += 1
    log(f"[3] ragged sweep: 5 lengths and {n_batches} batches of "
        f"fused_log_mel, {n_grids} grids of "
        f"asp_grid_stats within tolerance (worst share of it: "
        f"{worst['fused_log_mel']:.3f}, {worst['asp_grid_stats']:.3f})")


def seeded_encoders_phase(dev, vad, bench_cfg, der_pct, wave600, truth600,
                          k2_w80: str) -> dict:
    """Phase 4k: the encoders that ship no checkpoint, at their published
    widths on the seed-0 draw, written in a format each and loaded through
    the registry (every loader runs on the card's machine): ERes2NetV2 as
    .onnx (the port's own writer), CAM++ as .pt under ``state_dict``, a
    SpeechBrain-format ECAPA as embedding_model.ckpt; the CLI's ``diarize``
    on the card with each (and the trainer's .npz).  Card against CPU on
    8 windows of 2 s of the 60 s bench draw; the bench configuration
    (overlap on) on that draw with each: walls, the encoder's span on the
    card's clock, peak memory, launches by shape, DER within one point of
    the JAX CPU bar either way; ERes2NetV2 once on the 600 s draw with its
    busy share and bound.  Returns what the kernels line reads."""
    import copy
    import logging
    import re
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from speech_diarization_tpu_torch.dsp.framing import num_frames
    from speech_diarization_tpu_torch.dsp.mel import fbank_batch
    from speech_diarization_tpu_torch.cli import main as cli_main
    from speech_diarization_tpu_torch.io.audio import write_wav
    from speech_diarization_tpu_torch.io.onnx_lite import write_initializers
    from speech_diarization_tpu_torch.models.campp import CamPlusPlus
    from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn
    from speech_diarization_tpu_torch.models.eres2netv2 import ERes2NetV2
    from speech_diarization_tpu_torch.models.port_ecapa import ecapa_torch_manifest
    from speech_diarization_tpu_torch.models.registry import (
        make_encoder_model, seeded_state_dict,
    )
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.synthetic import make_conversation

    def tensors(manifest):
        return {k: torch.from_numpy(v) for k, v in seeded_state_dict(manifest, 0).items()}

    seeded = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {"eres2netv2": ("eres2netv2", Path(tmp) / "eres2netv2.onnx"),
                 "campp": ("campp", Path(tmp) / "campp.pt"),
                 "ecapa_speechbrain": ("ecapa", Path(tmp) / "embedding_model.ckpt")}
        write_initializers(ckpts["eres2netv2"][1],
                           seeded_state_dict(ERes2NetV2().manifest(), 0))
        torch.save({"state_dict": tensors(CamPlusPlus().manifest())}, ckpts["campp"][1])
        torch.save(tensors(ecapa_torch_manifest(EcapaTdnn())), ckpts["ecapa_speechbrain"][1])
        for tag, (backend, path) in ckpts.items():
            t0 = time.perf_counter()
            seeded[tag] = make_encoder_model(backend, path)
            log(f"[4k] {tag}: {path.name} ({path.stat().st_size / 1e6:.1f} MB) "
                f"through make_encoder_model in {time.perf_counter() - t0:.2f} s "
                f"({type(seeded[tag]).__name__}, "
                f"{sum(v.numel() for v in seeded[tag].state_dict().values()):,} values)")
        # the CLI on the card (no --cpu) with each format, and the trainer's
        # .npz, on the 60 s bench draw written as a WAV
        wave, truth = make_conversation(np.random.default_rng(0), 60.0,
                                        n_speakers=3, sr=SR)
        wav = Path(tmp) / "bench60.wav"
        write_wav(wav, wave, SR)
        for backend, path in [*ckpts.values(),
                              ("ecapa", HERE / "weights" / "ecapa_synthetic.npz")]:
            out = Path(tmp) / f"out_{path.name}"
            t0 = time.perf_counter()
            rc = cli_main(["diarize", str(wav), "--encoder", backend,
                           "--encoder-weights", str(path), "--out-dir", str(out),
                           "--format", "rttm"])
            rttm = out / "bench60.rttm"
            n = len(rttm.read_text().splitlines()) if rttm.exists() else 0
            log(f"[4k] CLI diarize --encoder {backend} --encoder-weights "
                f"{path.name} on the card: rc {rc}, {n} RTTM lines, "
                f"{time.perf_counter() - t0:.2f} s with the models' loading")
            if rc != 0 or n == 0:
                raise AssertionError(f"the CLI with {path.name} wrote no RTTM")
    wins = torch.from_numpy(np.stack([wave[i * 7 * SR:i * 7 * SR + 2 * SR]
                                      for i in range(8)]).astype(np.float32))
    def agree(out, ref) -> tuple[float, float]:
        """max abs error over the largest magnitude; least cosine"""
        return (((out - ref).abs().max() / ref.abs().max()).item(),
                torch.nn.functional.cosine_similarity(out, ref, dim=1).min().item())

    bad = []
    for tag, model in seeded.items():
        card = copy.deepcopy(model).to(dev)
        with torch.inference_mode():
            # the net alone on the CPU's features, then all of encode_batch
            # (K2's log-mel on the card); and how far the CPU's own
            # embeddings move when the features move by one part in 1e7
            feats = fbank_batch(wins, sample_rate=SR, n_mels=model.net.n_mels)
            nets = [getattr(m.net, "embed_utterances", m.net) for m in (model, card)]
            ref_net = nets[0](feats)
            net_rel, net_cos = agree(nets[1](feats.to(dev)).cpu(), ref_net)
            g = torch.Generator().manual_seed(1)
            sens, _ = agree(nets[0](feats * (1 + 1e-7 * torch.randn(
                feats.shape, generator=g))), ref_net)
            ref = model.encode_batch(wins)
            out = card.encode_batch(wins.to(dev)).cpu()
        rel, cos = agree(out, ref)
        tol = ENC_TOL_REL[tag]
        log(f"[4k] {tag} card vs CPU, 8 windows of 2 s: the net on the same "
            f"features max abs error {net_rel:.2e} of the peak, least cos "
            f"{net_cos:.8f}; encode_batch {rel:.2e} of the peak "
            f"{ref.abs().max().item():.3f}, least cos {cos:.8f} (bars {tol:g} and "
            f"{ENC_COS}); the CPU's embeddings under a 1e-7 relative "
            f"perturbation of the features move {sens:.2e} of the peak; "
            f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn={torch.backends.cudnn.allow_tf32}")
        if not (max(net_rel, rel) < tol and min(net_cos, cos) >= ENC_COS
                and torch.isfinite(out).all()):
            bad.append(tag)
    if bad:
        raise AssertionError(f"{bad}: the card disagrees with the CPU")

    def span_encoder(pipe):
        """The pipeline's encoder wrapped in CUDA events, one span a batch."""
        inner, spans = pipe.encoder.encode_batch, []

        def encode_batch(wavs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(wavs)
            e1.record()
            spans.append((e0, e1))
            return out

        pipe.encoder.encode_batch = encode_batch
        return spans

    seeded_runs = {}
    for tag, model in seeded.items():
        pipe = DiarizationPipeline(bench_cfg(True), encoder=model, vad=vad)
        spans = span_encoder(pipe)
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = pipe((wave, SR))
        warm = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        n_launch, n_forms = dict(kernels.LAUNCHES), dict(kernels.LAUNCH_FORMS)
        n_shapes = dict(kernels.LAUNCH_SHAPES)
        walls, enc_ms = [], []
        for _ in range(3):
            spans.clear()
            t0 = time.perf_counter()
            pipe((wave, SR))
            walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            enc_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        d = res.diagnostics
        der = der_pct(truth, res.segments)
        jax_der = JAX_CPU_DER_PCT_SEEDED[tag]
        # the float32 bound of the 581 windows' convolutions and linears
        # (ECAPA's are functional convolutions, not counted here)
        net = pipe.encoder.net
        b60 = (f"{bound(0.0, {'f32': conv_flops(net, 201, 80) * 581})[0]:.1f} ms"
               if isinstance(net, (ERes2NetV2, CamPlusPlus)) else "not computed")
        log(f"[4k] {tag}, 60 s: route {d.get('route')}, grid {d.get('grid')}; warm "
            f"{warm:.3f} s, timed {min(walls):.4f} s (walls "
            f"{[round(w, 4) for w in walls]}); encoder {min(enc_ms):.2f} ms on the "
            f"card's clock ({[round(m, 2) for m in enc_ms]}; float32 bound "
            f"{b60}); peak device memory "
            f"{peak_gb:.2f} GB above the resident set; {len(res.segments)} segments, "
            f"{res.num_speakers} speakers, DER {der:.4f} % (JAX CPU {jax_der:.4f} % "
            f"+- {DER_SLACK_PCT}); launches {n_launch} {n_forms} {n_shapes}")
        grid = d["window_embeddings"]
        if d.get("route") != "legacy" or d.get("grid") != "windowed" or not (
                np.isfinite(grid).all() and grid.shape == (581, 192)):
            raise AssertionError(f"{tag}: route {d.get('route')}, grid "
                                 f"{d.get('grid')} {grid.shape}")
        # the VAD's and the detector's batches, and the grid's 512 + 69 windows
        want = {"asp_grid_stats": 0, "fused_log_mel": 4, "resample_poly": 0}
        if n_launch != want or n_forms != {"fused_log_mel[B, T]": 4} or (
                n_shapes.get(k2_w80) != 2):
            raise AssertionError(f"{tag}: launch counts {n_launch} {n_forms} {n_shapes}")
        if not abs(der - jax_der) <= DER_SLACK_PCT:
            raise AssertionError(f"{tag}: DER {der:.4f} % more than {DER_SLACK_PCT} "
                                 f"point from the JAX CPU {jax_der:.4f} %")
        seeded_runs[tag] = {"shapes": n_shapes, "wall": min(walls),
                            "enc_ms": min(enc_ms)}
        if tag == "eres2netv2":
            pipe_600, spans_600 = pipe, spans

    # ERes2NetV2 on the 600 s draw: one call for the wall, the encoder's span,
    # peak memory, stage walls and launches, one under the profiler for the
    # busy share and the device time by kernel
    class StageLog(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.walls = {}

        def emit(self, record):
            m = re.match(r"stage=(\S+) wall_s=([0-9.]+)", record.getMessage())
            if m:
                self.walls[m.group(1)] = float(m.group(2))

    pipe, spans = pipe_600, spans_600
    stages = StageLog()
    diar_log = logging.getLogger("sdtpu.diarize")
    diar_log.addHandler(stages)
    level = diar_log.level
    diar_log.setLevel(logging.INFO)
    spans.clear()
    kernels.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = pipe((wave600, SR))
    wall600 = time.perf_counter() - t0
    diar_log.setLevel(level)
    diar_log.removeHandler(stages)
    peak600 = (torch.cuda.max_memory_allocated() - base) / 1e9
    enc600 = sum(a.elapsed_time(b) for a, b in spans)
    shapes600 = dict(kernels.LAUNCH_SHAPES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe((wave600, SR))
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    kern = kernel_times_us(prof)
    busy = sum(kern.values()) / 1e6
    # the least time for the convolutions and linears of 5,981 windows
    # (2 multiply-adds' operations each) at the float32 rate, TF32 off
    flops = conv_flops(pipe.encoder.net, 201, 80) * num_frames(600 * SR, 32000, 1600)
    b_ms, _ = bound(0.0, {"f32": flops})
    der600 = der_pct(truth600, res.segments)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    log(f"[4k] eres2netv2, 600 s: wall {wall600:.4f} s (RTF {600 / wall600:.1f}x; "
        f"under the profiler {wall_prof:.4f} s), device busy {busy:.4f} s = "
        f"{100 * busy / wall_prof:.1f} % of the profiled wall; encoder "
        f"{enc600:.1f} ms on the card's clock against a float32 bound of "
        f"{b_ms:.1f} ms ({flops / 1e12:.2f} TFLOP of convolutions and linears "
        f"at 67 TFLOP/s: {100 * b_ms / enc600:.1f} % of it); peak device memory "
        f"{peak600:.2f} GB above the resident set; DER {der600:.4f} % (no JAX "
        f"bar at 600 s); stages {stages.walls}; K2 launches {shapes600}; top "
        f"device kernels (ms) {[(k[:140], round(v / 1e3, 1)) for k, v in top]}")
    if shapes600.get(k2_w80) != 12 or not np.isfinite(
            res.diagnostics["window_embeddings"]).all():
        raise AssertionError(f"eres2netv2 600 s: launches {shapes600}")
    return {"runs": seeded_runs, "shapes600": shapes600, "wall600": wall600}


def graph_flops(net, *inputs) -> float:
    """Operations (two per multiply-add) of one forward of ``net``, counted
    from the shapes it meets: its convolutions, transposed convolutions and
    linears, and the products inside its attention modules (HTDemucs'
    projections, scores and weighted sums; ZipEnhancerRef's scores,
    relative position scores and the three products with its attention
    weights).  The STFT / iSTFT products of ZipEnhancerRef are counted from
    its frames; HTDemucs' FFTs, norms and pointwise work are not counted."""
    import torch

    from speech_diarization_tpu_torch.models import demucs_ref, zipenhancer_ref

    total = [0.0]

    def hook(mod, inp, out):
        x = inp[0]
        if isinstance(mod, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * mod.in_features
        elif isinstance(mod, (torch.nn.ConvTranspose1d, torch.nn.ConvTranspose2d)):
            total[0] += (2.0 * x.numel() * mod.out_channels // mod.groups
                         * float(np.prod(mod.kernel_size)))
        elif isinstance(mod, (torch.nn.Conv1d, torch.nn.Conv2d)):
            total[0] += (2.0 * out.numel() * (mod.in_channels // mod.groups)
                         * float(np.prod(mod.kernel_size)))
        elif isinstance(mod, demucs_ref.MultiheadAttention):
            b, lq, d = x.shape
            lk = inp[1].shape[1]
            total[0] += 2.0 * b * (lq + 2 * lk) * d * d + 4.0 * b * lq * lk * d
        elif isinstance(mod, zipenhancer_ref.RelPositionAttentionWeights):
            n, s, _ = x.shape
            total[0] += 2.0 * n * mod.heads * s * s * (mod.qhd + mod.phd)
        elif isinstance(mod, zipenhancer_ref.SelfAttention):
            n, s, _ = x.shape
            total[0] += 2.0 * n * mod.heads * s * s * mod.vhd
        elif isinstance(mod, zipenhancer_ref.NonlinAttention):
            n, s, _ = x.shape
            total[0] += 2.0 * n * s * s * (mod.in_proj.out_features // 3)

    kinds = (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.ConvTranspose1d,
             torch.nn.ConvTranspose2d, torch.nn.Linear, demucs_ref.MultiheadAttention,
             zipenhancer_ref.RelPositionAttentionWeights, zipenhancer_ref.SelfAttention,
             zipenhancer_ref.NonlinAttention)
    handles = [m.register_forward_hook(hook) for m in net.modules() if isinstance(m, kinds)]
    try:
        with torch.inference_mode():
            net(*inputs)
    finally:
        for h in handles:
            h.remove()
    if isinstance(net, zipenhancer_ref.ZipEnhancerRef):
        b, t = inputs[0].shape
        frames = 1 + t // net.hop
        total[0] += 2 * (2.0 * b * frames * net.n_fft * 2 * net.n_bins)
    return total[0]


# K3 on the card against scipy's float64 resampling: at most one float32
# ulp apart (both sum float64 products, in other orders, and round once)
K3_MAX_ULPS = 1
# K3 against its bound (bytes or float64 FMAs, the larger) at the
# htdemucs.babble cell's shapes
K3_MAX_OVER_BOUND = 10.0


def _f32_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance of two float32 arrays in units in the last place."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(ordered(a) - ordered(b))


def _zero_stuffed_resample(y, up: int, down: int):
    """The port's former device resampling, kept here only as the yardstick
    (``library_ms``): the wave zero-stuffed by ``up``, padded so that the
    filter's centre tap sits on the first sample, and correlated with the
    reversed filter at stride ``down`` by one float32 ``conv1d``."""
    import torch
    import torch.nn.functional as F

    from speech_diarization_tpu_torch.dsp.resample import _poly_filter

    h = torch.from_numpy(_poly_filter(up, down)[::-1].astype(np.float32)).to(y.device)
    t = y.shape[-1]
    n_out = -(-t * up // down)
    stuffed = y.new_zeros((1, (t - 1) * up + 1))
    stuffed[0, ::up] = y
    lo = (h.numel() - 1) // 2
    hi = max(0, (n_out - 1) * down + h.numel() - lo - stuffed.shape[1])
    return F.conv1d(F.pad(stuffed, (lo, hi))[:, None], h[None, None],
                    stride=down)[0, 0, :n_out]


def resample_phase(dev) -> dict:
    """K3 (``csrc/resample_poly.cu``) at the htdemucs.babble cell's shapes:
    a 117 s babble draw padded to 120 s with zeros (as ``_load_waves``
    pads to whole minutes) and a 300 s draw, each from 16 to 44.1 kHz, and
    their 44.1 kHz resampled waves (the mono dialog stem's shape) back.
    Each against scipy (``resample_host``, the plain version, timed on the
    host): every sample within ``K3_MAX_ULPS``; its time (CUDA events)
    within ``K3_MAX_OVER_BOUND`` of its bound; the former zero-stuffed
    ``conv1d``'s time and peak memory at 120 s as the yardstick.  The
    wrapper makes no host sync.  Then the demix-dialog enhancer (a small
    seeded HTDemucs ensemble of two) on a 20 s and a 35 s file under a span
    recorder: K3 launched twice a file (once each way, by ``up`` / ``down``),
    the resampling spans timed on the card's clock, no demix span a wait and
    none a copy, and its output against the same enhancer on the CPU
    (scipy's resampling) within ``DEMIX_TOL_REL``."""
    import copy

    import torch

    from speech_diarization_tpu_torch.dsp.resample import resample_host, resample_poly
    from speech_diarization_tpu_torch.models.demucs_ref import HTDemucsRef
    from speech_diarization_tpu_torch.models.registry import seeded_init
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.ops.cost import resample_poly_work
    from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn
    from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout
    from speech_diarization_tpu_torch.utils.logging import file_scope, recording

    t_phase = time.perf_counter()
    w117, _ = make_conversation_heldout(np.random.default_rng(24), 117.0, n_speakers=3,
                                        sr=SR, snr_db=10.0, noise_kind="babble")
    w300, _ = make_conversation_heldout(np.random.default_rng(25), 300.0, n_speakers=3,
                                        sr=SR, snr_db=10.0, noise_kind="babble")
    waves = {"120s": np.pad(np.clip(w117, -1, 1), (0, 120 * SR - len(w117))),
             "300s": np.clip(w300, -1, 1)}
    out = {"name": "resample_poly", "route": "cuda",
           "source": "speech_diarization_tpu_torch/csrc/resample_poly.cu",
           "replaces": "none (JAX: speech_diarization_tpu/dsp/resample.py::resample_poly_jax)",
           "ms": {}, "plain_ms": {}, "bound_ms": {}, "bound_by": {}, "library_ms": {},
           "library_peak_gb": {}, "max_ulps": {}, "max_abs_err": 0.0}
    failed = []
    for tag, w in waves.items():
        w = w.astype(np.float32)
        t0 = time.perf_counter()
        up_ref = resample_host(w, SR, 44100)
        up_host_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        down_ref = resample_host(up_ref, 44100, SR)
        down_host_ms = 1e3 * (time.perf_counter() - t0)
        for leg, x, ref, sr_in, sr_out, host_ms in (
                ("up", w, up_ref, SR, 44100, up_host_ms),
                ("down", up_ref, down_ref, 44100, SR, down_host_ms)):
            key = f"{leg} {tag}"
            xd = torch.from_numpy(x).to(dev)
            got = resample_poly(xd, sr_in, sr_out).cpu().numpy()
            ulps = int(_f32_ulps(got, ref).max()) if got.shape == ref.shape else -1
            err = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
            ms = cuda_time_ms(lambda: resample_poly(xd, sr_in, sr_out), 20)
            up, down = (441, 160) if leg == "up" else (160, 441)
            work = resample_poly_work(1, x.size, ref.size, up, down)
            b_ms, b_by = bound(work["bytes"], work["ops"])
            out["ms"][key], out["plain_ms"][key] = ms, host_ms
            out["bound_ms"][key], out["bound_by"][key] = b_ms, b_by
            out["max_ulps"][key] = ulps
            out["max_abs_err"] = max(out["max_abs_err"], err)
            log(f"[3r] K3 {key} ({x.size} -> {ref.size} samples, peak "
                f"{np.abs(ref).max():.3f}): max {ulps} ulp, max abs err {err:.3e} "
                f"from scipy; {ms:.4f} ms on the card, bound {b_ms:.4f} ms "
                f"({b_by}; {ms / b_ms:.2f}x), scipy on the host {host_ms:.1f} ms")
            if not 0 <= ulps <= K3_MAX_ULPS:
                failed.append(f"{key}: {ulps} ulp from scipy (shape {got.shape})")
            if not ms <= K3_MAX_OVER_BOUND * b_ms:
                failed.append(f"{key}: {ms:.4f} ms, over {K3_MAX_OVER_BOUND}x the "
                              f"bound {b_ms:.4f} ms")
            if tag == "120s":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                try:
                    lib_ms = cuda_time_ms(lambda: _zero_stuffed_resample(xd, up, down), 3)
                    lib_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
                    lib_err = float(np.abs(
                        _zero_stuffed_resample(xd, up, down).cpu().numpy() - ref).max())
                    out["library_ms"][key], out["library_peak_gb"][key] = lib_ms, lib_peak
                    log(f"[3r] zero-stuffed conv1d {key} (the yardstick, off the "
                        f"path): {lib_ms:.3f} ms, {lib_peak:.2f} GB above the "
                        f"resident set, max abs err {lib_err:.3e} from scipy")
                except RuntimeError as e:
                    out["library_ms"][key] = None
                    log(f"[3r] zero-stuffed conv1d {key}: not measured ({e})")
                torch.cuda.empty_cache()
            del xd
    # the wrapper, its bank cached, never waits on the card
    y = torch.from_numpy(waves["120s"].astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        resample_poly(resample_poly(y, SR, 44100), 44100, SR)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the demix-dialog enhancer: two launches a file, nothing waits
    small = dict(channels=8, depth=4, nfft=512, bottom_channels=16, t_layers=2,
                 t_heads=2)
    nets = [seeded_init(HTDemucsRef(**small), s).eval() for s in (0, 1)]
    card_fn = make_enhance_fn("demix-dialog", device=dev,
                              nets=[copy.deepcopy(n) for n in nets], chunk_s=4.0)
    cpu_fn = make_enhance_fn("demix-dialog", device="cpu", nets=nets, chunk_s=4.0)
    files = [w117[:20 * SR].astype(np.float32), w300[:35 * SR].astype(np.float32)]
    card_fn(torch.from_numpy(files[0]).to(dev))     # the bank and the nets warm
    torch.cuda.synchronize()
    kernels.reset_launches()
    with recording() as rec, torch.inference_mode():
        outs = []
        for i, f in enumerate(files):
            with file_scope(i):
                outs.append(card_fn(torch.from_numpy(f).to(dev)))
        torch.cuda.synchronize()
        rec.resolve()
    launches, shapes = dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES)
    spans = [sp for sp in rec.spans if sp.name.startswith("demix.")]
    rs = [sp for sp in spans if sp.name.startswith("demix.resample")]
    diffs = []
    with torch.inference_mode():
        for f, o in zip(files, outs):
            ref = cpu_fn(torch.from_numpy(f)).numpy()
            diffs.append(float(np.abs(o.cpu().numpy() - ref).max() / np.abs(ref).max()))
    out["launches_demix_file"] = launches["resample_poly"] / len(files)
    out["demix_resample_device_ms"] = [round(sp.device_ms, 4) for sp in rs
                                       if sp.device_ms is not None]
    log(f"[3r] demix-dialog enhancer on 20 s and 35 s: K3 launches {launches} "
        f"{ {k: v for k, v in shapes.items() if k.startswith('resample_poly')} }; "
        f"resampling spans on the card's clock "
        f"{[(sp.name, sp.device_ms and round(sp.device_ms, 4), round(sp.wall_ms, 4)) for sp in rs]} "
        f"(device ms, host ms); demix spans {sorted({sp.name for sp in spans})}; "
        f"card vs CPU max rel err {[f'{d:.2e}' for d in diffs]} (bar {DEMIX_TOL_REL:.0e})")
    if launches["resample_poly"] != 2 * len(files) or {
            k: v for k, v in shapes.items() if k.startswith("resample_poly")} != {
            "resample_poly up 441 down 160": len(files),
            "resample_poly up 160 down 441": len(files)}:
        failed.append(f"demix-dialog: K3 launches {launches} {shapes}")
    if len(rs) != 2 * len(files) or any(sp.device_ms is None for sp in rs):
        failed.append("demix-dialog: a resampling span is not on the card's clock")
    if any(sp.wait for sp in spans) or {"demix.download", "demix.upload", "demix.fetch",
                                         "demix.return"} & {sp.name for sp in spans}:
        failed.append("demix-dialog: the front-end copies or waits")
    if not max(diffs) <= DEMIX_TOL_REL:
        failed.append(f"demix-dialog: card vs CPU {max(diffs):.3e}")
    out["wall"] = time.perf_counter() - t_phase
    log(f"[3r] K3 phase took {out['wall']:.1f} s")
    if failed:
        raise AssertionError("[3r] " + "; ".join(failed))
    return out


def published_graphs_phase(dev, enc, vad, bench_cfg, noisy_route, noisy600, y10) -> dict:
    """Phase 4l: the published enhancer graphs and their checkpoint
    importers on seeded weights.  Writes three full-width HTDemucs packages
    (``{kwargs, state}`` .th, seeds 0, 1, 2), a ModelScope-style
    ZipEnhancerRef ``pytorch_model.bin`` (``generator.``-prefixed, with a
    balancer and a ``num_batches_tracked`` entry that the importer drops;
    seed 0, also as an .npz) and ``gtcrn_mc.npz`` as a DNS3-style tar; holds
    each graph on the card against the CPU, the tar against the npz, times
    the HTDemucs ensemble on the 600 s file's 80 chunks and ZipEnhancerRef
    on a 64-window batch and on the 400 windows of 600 s beside their
    float32 bounds, runs the routes (zipenhancer-ref on white10 60 s,
    demix-dialog and the default config's auto-route with the .th files on
    babble15 60 s, DER within one point of the JAX CPU bars either way;
    both graphs once on white10 600 s for the wall and the busy share), and
    the CLI's ``enhance`` / ``demix`` with these files.  Restores
    ``SDTPU_DEMUCS_CKPTS``.  Returns what the kernels line reads."""
    import copy
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from speech_diarization_tpu_torch.cli import main as cli_main
    from speech_diarization_tpu_torch.config import EnhanceConfig
    from speech_diarization_tpu_torch.dsp.framing import frame_signal, num_frames
    from speech_diarization_tpu_torch.dsp.resample import resample_host
    from speech_diarization_tpu_torch.io.audio import write_wav
    from speech_diarization_tpu_torch.models.demucs_ref import HTDemucsRef
    from speech_diarization_tpu_torch.models.port import (
        load_gtcrn_checkpoint, load_params_npz,
    )
    from speech_diarization_tpu_torch.models.port_demucs import load_htdemucs
    from speech_diarization_tpu_torch.models.port_zipenhancer import (
        load_zipenhancer_modelscope,
    )
    from speech_diarization_tpu_torch.models.registry import seeded_state_dict
    from speech_diarization_tpu_torch.models.zipenhancer_ref import ZipEnhancerRef
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.pipelines.demix import EnsembleDemixer
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.pipelines.enhance import (
        make_enhance_fn, windowed_enhance,
    )

    env_before = os.environ.get("SDTPU_DEMUCS_CKPTS")
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = Path(tmp_dir.name)
    try:
        # ----------------------------------------------- the checkpoints ---
        t0 = time.perf_counter()
        ths = []
        man = HTDemucsRef().manifest()
        for seed in range(3):
            ths.append(tmp / f"htdemucs_seed{seed}.th")
            torch.save({"kwargs": {"sources": ["music", "effect", "dialog"]},
                        "state": {k: torch.from_numpy(v) for k, v in
                                  seeded_state_dict(man, seed).items()}}, ths[-1])
        zip_sd = seeded_state_dict(ZipEnhancerRef().manifest(), 0)
        zip_npz = tmp / "zipenhancer_ref_seed0.npz"
        np.savez(zip_npz, **zip_sd)
        bundle = {f"generator.{k}": torch.from_numpy(v) for k, v in zip_sd.items()}
        bundle["generator.ts_blocks.0.time.encoder.layers.0.balancer1.prob"] = torch.zeros(1)
        bundle["generator.dense_encoder.dense_conv_1.1.num_batches_tracked"] = (
            torch.zeros((), dtype=torch.long))
        zip_bin = tmp / "pytorch_model.bin"
        torch.save(bundle, zip_bin)
        gtcrn_sd = load_params_npz(HERE / "weights" / "gtcrn_mc.npz")
        tar = tmp / "model_trained_on_dns3.tar"
        torch.save({"model": {k: torch.from_numpy(v) for k, v in gtcrn_sd.items()}}, tar)
        os.environ["SDTPU_DEMUCS_CKPTS"] = ":".join(map(str, ths))
        log(f"[4l] wrote 3 HTDemucs .th ({ths[0].stat().st_size / 1e6:.1f} MB each), "
            f"{zip_bin.name} ({zip_bin.stat().st_size / 1e6:.1f} MB), {tar.name} in "
            f"{time.perf_counter() - t0:.2f} s")

        # -------------------------------------------- card against CPU ---
        htd_cpu = load_htdemucs(ths[0])
        zip_cpu = load_zipenhancer_modelscope(zip_bin)
        up10 = resample_host(noisy600[:10 * SR].astype(np.float32), SR, 44100)
        chunk = torch.from_numpy(np.stack([up10, up10])[None])          # [1, 2, 441000]
        x4 = y10[:4 * 32000].reshape(4, 32000)
        errs = {}
        with torch.inference_mode():
            for tag, net, x, tol in (("HTDemucs", htd_cpu, chunk, HTDEMUCS_TOL_REL),
                                     ("ZipEnhancerRef", zip_cpu, x4, ZIPREF_TOL_REL)):
                ref = net(x)
                out = copy.deepcopy(net).to(dev)(x.to(dev)).cpu()
                errs[tag] = float((out - ref).abs().max() / ref.abs().max())
                log(f"[4l] {tag} card vs CPU on {tuple(x.shape)}: max abs error "
                    f"{errs[tag]:.3e} of the peak {ref.abs().max().item():.4f} (bar "
                    f"{tol:.0e}); allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
                    f"cudnn={torch.backends.cudnn.allow_tf32}")
                if not (errs[tag] <= tol and torch.isfinite(out).all()):
                    raise AssertionError(f"{tag} on the card disagrees with the CPU")
        del htd_cpu

        # ---------------------------------------------- the GTCRN tar ---
        tar_fn = make_enhance_fn("gtcrn", weights=load_gtcrn_checkpoint(tar).state_dict(),
                                 device=dev)
        same = torch.equal(tar_fn(y10.to(dev)), make_enhance_fn("gtcrn", device=dev)(
            y10.to(dev)))
        log(f"[4l] GTCRN from the DNS3 tar on 10 s equals gtcrn_mc.npz's output: {same}")
        if not same:
            raise AssertionError("the GTCRN tar's output differs from the npz's")

        # ------------------------------------------ spans and bounds ---
        spans = {}
        dmx = EnsembleDemixer(device=dev)
        up600 = resample_host(noisy600.astype(np.float32), SR, 44100)
        x80 = frame_signal(torch.from_numpy(np.stack([up600, up600])).to(dev),
                           441000, 330750).transpose(0, 1)
        del up600
        with torch.inference_mode():
            htd_flops = graph_flops(dmx.nets[0], x80[:1])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            spans["htdemucs_80"] = cuda_time_ms(lambda: dmx._forward(x80), 1)
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        n_fwd = x80.shape[0] * len(dmx.nets)
        b_ms, _ = bound(0.0, {"f32": htd_flops * n_fwd})
        log(f"[4l] HTDemucs ensemble of {len(dmx.nets)} on the 600 s file's "
            f"{x80.shape[0]} chunks of [2, 441000] (batches of {dmx.CHUNK_BATCH}): "
            f"{spans['htdemucs_80']:.1f} ms on the card's clock, {peak:.2f} GB above "
            f"the resident set; {htd_flops / 1e9:.1f} GFLOP a chunk (XLA's count "
            f"464.5) x {n_fwd} = {htd_flops * n_fwd / 1e12:.2f} TFLOP, float32 bound "
            f"{b_ms:.1f} ms ({100 * b_ms / spans['htdemucs_80']:.1f} % of it)")
        del x80, dmx
        zip_card = load_zipenhancer_modelscope(zip_bin).to(dev)
        y600 = torch.from_numpy(noisy600.astype(np.float32)).to(dev)
        n_win = num_frames(600 * SR, 32000, 24000, pad_tail=True)
        with torch.inference_mode():
            x64 = y600[:63 * 24000 + 32000].unfold(0, 32000, 24000)
            zip_flops = graph_flops(zip_card, x64[:1])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            spans["zipref_64"] = cuda_time_ms(lambda: zip_card(x64), 3)
            peak64 = (torch.cuda.max_memory_allocated() - base) / 1e9
            spans["zipref_600s"] = cuda_time_ms(lambda: windowed_enhance(zip_card, y600), 1)
        for key, n in (("zipref_64", 64), ("zipref_600s", n_win)):
            b_ms, _ = bound(0.0, {"f32": zip_flops * n})
            log(f"[4l] ZipEnhancerRef on {n} windows of 2 s"
                f"{' (the 600 s file through windowed_enhance)' if n == n_win else ''}: "
                f"{spans[key]:.1f} ms on the card's clock; {zip_flops / 1e9:.1f} GFLOP a "
                f"window (XLA's count 195.1) x {n} = {zip_flops * n / 1e12:.2f} TFLOP, "
                f"float32 bound {b_ms:.1f} ms ({100 * b_ms / spans[key]:.1f} % of it)"
                + (f"; {peak64:.2f} GB above the resident set" if n == 64 else ""))
        del zip_card, y600, x64

        # ------------------------------------------------------ routes ---
        def timed(pipe, attr):
            inner, spans_ = getattr(pipe, attr), []

            def fn(y):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = inner(y)
                e1.record()
                spans_.append((e0, e1))
                return out

            setattr(pipe, attr, fn)
            return spans_

        def route_pipe(tag):
            cfg = {"zipenhancer-ref": EnhanceConfig(backend="zipenhancer-ref",
                                                    weights=str(zip_npz)),
                   "demix-dialog": EnhanceConfig(backend="demix-dialog"),
                   "auto": EnhanceConfig()}[tag]
            pipe = DiarizationPipeline(bench_cfg(True, enhance=cfg), encoder=enc, vad=vad)
            if tag == "auto":
                pipe._demix_frontend()          # built once, then timed
                return pipe, timed(pipe, "_demix_fe")
            return pipe, timed(pipe, "enhance_fn")

        runs, ders = {}, {}
        for tag, noise, snr in (("zipenhancer-ref", "white", 10.0),
                                ("demix-dialog", "babble", 15.0),
                                ("auto", "babble", 15.0)):
            pipe, sp = route_pipe(tag)
            backend = "demix-dialog" if tag == "auto" else tag
            r = noisy_route("4l", pipe, sp, backend, noise, snr, 60, None)
            jax_der = JAX_CPU_DER_PCT_PUBLISHED[tag]
            ders[tag] = (r["der"], jax_der)
            log(f"[4l] {tag} ({'auto-route, ' if tag == 'auto' else ''}{noise}{snr:g} "
                f"60 s): DER {r['der']:.4f} % against the JAX CPU bar "
                f"{jax_der} % +- {DER_SLACK_PCT}; K1 / K2 launches by shape {r['shapes']}")
            if jax_der is not None and not abs(r["der"] - jax_der) <= DER_SLACK_PCT:
                raise AssertionError(f"{tag}: DER {r['der']:.4f} % more than "
                                     f"{DER_SLACK_PCT} point from {jax_der} %")
        for tag, run_tag in (("zipenhancer-ref", "zipenhancer-ref_white10_600s"),
                             ("demix-dialog", "htdemucs_white10_600s")):
            pipe, sp = route_pipe(tag)
            r = noisy_route("4l", pipe, sp, tag, "white", 10.0, 600, None, n_timed=1)
            # noisy600 is the same draw (seed 0, white noise at 10 dB)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                pipe((noisy600, SR))
                torch.cuda.synchronize()
                wall_prof = time.perf_counter() - t0
            kern = kernel_times_us(prof)
            busy = sum(kern.values()) / 1e6
            top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
            r.update(busy=busy, wall_prof=wall_prof)
            runs[run_tag] = r
            log(f"[4l] {tag} on white10 600 s: wall {r['wall']:.4f} s (RTF "
                f"{600 / r['wall']:.1f}x; under the profiler {wall_prof:.4f} s), device "
                f"busy {busy:.4f} s = {100 * busy / wall_prof:.1f} % of the profiled "
                f"wall; enhancer {r['ms']:.1f} ms; peak {r['peak_gb']:.2f} GB; DER "
                f"{r['der']:.4f} % (no JAX bar at 600 s); top device kernels (ms) "
                f"{[(k[:120], round(v / 1e3, 1)) for k, v in top]}")

        # --------------------------------------------------------- CLI ---
        wav_dir = tmp / "cli" / "in"
        write_wav(wav_dir / "noisy10.wav", y10.numpy(), SR)
        for argv, out in (
                (["enhance", str(wav_dir), "--backend", "zipenhancer-ref", "--weights",
                  str(zip_bin)], wav_dir.with_name("in-enhanced") / "noisy10.wav"),
                (["enhance", str(wav_dir), "--backend", "gtcrn", "--weights", str(tar)],
                 wav_dir.with_name("in-enhanced") / "noisy10.wav"),
                (["demix", str(wav_dir), "--output", str(tmp / "cli" / "stems")],
                 tmp / "cli" / "stems" / "dialog" / "noisy10.wav")):
            t0 = time.perf_counter()
            rc = cli_main(argv)
            log(f"[4l] CLI {' '.join(a if '/' not in a else Path(a).name for a in argv)} "
                f"on the card: rc {rc}, wrote {out.relative_to(tmp)}: {out.exists()}, "
                f"{time.perf_counter() - t0:.2f} s with the models' loading")
            if rc != 0 or not out.exists():
                raise AssertionError(f"the CLI's {argv[0]} wrote nothing")
            if argv[0] == "enhance":
                out.unlink()
    finally:
        if env_before is None:
            os.environ.pop("SDTPU_DEMUCS_CKPTS", None)
        else:
            os.environ["SDTPU_DEMUCS_CKPTS"] = env_before
        tmp_dir.cleanup()
    return {"runs": runs, "ders": ders, "errs": errs, "spans": spans}


# tolerances of a training step on the card against the CPU (step 1, same
# parameters and batch, TF32 off): the loss's relative difference; the
# cosine of the flattened gradients and their largest difference relative
# to the largest gradient
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_COS = 0.9999
# 1e-3, but 1e-2 for the proto encoder: K2's 3xTF32 log-mel differs from
# the plain float32 one within its tolerance (at this batch by 4.5e-6 rms,
# 3.7e-4 at most), and the stem's weight gradient sums those features.  On
# an H100, K2's features move that gradient by 5.0e-3 of the largest, and
# Gaussian noise of 1e-5 on the plain features by 6.3e-4-5.0e-3 (16 draws;
# scripts/torch_train_grad_noise.py)
TRAIN_GRAD_REL = {"encoder-proto": 1e-2}


def train_step_flops(loss_fn, batch) -> float:
    """Operations (two per multiply-add) of one forward of a training loss,
    counted by ``torch.utils.flop_counter`` from the products and
    convolutions it meets."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        loss_fn(*batch)
    return float(fc.get_total_flops())


def training_phase(dev, smi, bench_cfg, der_pct) -> dict:
    """Phase 6: the training recipes that made the shipped main-path
    weights, at the shipped widths, warm-started from those weights.  For
    each configuration: step 1 on the card against the port's CPU path
    (same parameters, same batch); ten steps after a warm-up (median ms a
    step on CUDA events beside its float32 bound, peak memory allocated
    above what was resident before the steps, K2's
    launches a step by shape, the busy share of two profiled steps, the
    loss curve, finite); the export after 0 steps equal to the shipped npz
    (float16 -> float32) and, loaded into the pipeline, the shipped file's
    segments; a checkpoint saved after step 5 and restored gives step 6's
    loss and, after its update, leaves exactly.  K2's training geometries against its plain version and
    ``torch.stft`` (``k2_measure``).  Returns the results by configuration
    and the K2 rows."""
    import dataclasses
    import shutil
    import tempfile
    from functools import partial

    import torch

    from speech_diarization_tpu_torch.config import EnhanceConfig, OverlapConfig
    from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn
    from speech_diarization_tpu_torch.models.port import (
        load_params_meta, load_params_npz, load_segmentation, load_speaker_encoder,
        load_vad,
    )
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train import multicond as mc
    from speech_diarization_tpu_torch.train import recipes
    from speech_diarization_tpu_torch.train.checkpoint import (
        export_inference_weights, restore_train_state, save_train_state,
    )
    from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout
    from speech_diarization_tpu_torch.train.proto import proto_job
    from speech_diarization_tpu_torch.train.steps import (
        apply_step, make_ecapa_train_step,
    )
    from speech_diarization_tpu_torch.train.synthetic import (
        make_conversation, make_speaker_bank, make_speaker_batch,
    )

    t_phase = time.perf_counter()
    wdir = HERE / "weights"
    files = {"vad": "vad_conv_mc.npz", "encoder-proto": "ecapa_robust_stream.npz",
             "segmentation": "segmentation_conv.npz", "gtcrn": "gtcrn_mc.npz",
             "ecapa_train_step": "ecapa_robust_stream.npz"}
    flat = {k: load_params_npz(wdir / f) for k, f in files.items()}
    enc_meta = load_params_meta(wdir / files["encoder-proto"])
    enc_cfg = dict(enc_meta["net"], dilations=tuple(enc_meta["net"]["dilations"]))
    seg_meta = load_params_meta(wdir / files["segmentation"])["net"]
    seg_kw = {k: seg_meta[k] for k in ("powerset", "channels", "hidden", "n_gru",
                                       "n_fc", "ds", "arch", "n_xf", "n_heads")}

    class StepJob:
        """``make_ecapa_train_step`` behind the recipes' job interface."""

        def __init__(self, device):
            self.net = EcapaTdnn(**enc_cfg)
            init_fn, self.step_fn, shard = make_ecapa_train_step(device, self.net, 64)
            cls = np.random.default_rng(0).standard_normal(
                (64, self.net.emb_dim)).astype(np.float32) * 0.05
            self.state = shard(init_fn(params={**flat["ecapa_train_step"],
                                               "classifier": cls}))
            self.loss_fn = lambda w, l: self.step_fn.loss_fn(self.state.params, w, l)
            self.device = torch.device(device)

        def batch_tensors(self, batch):
            return tuple(torch.as_tensor(b).to(self.device) for b in batch)

    bank = make_speaker_bank(np.random.default_rng(8), 64)
    # each configuration: (recipe and batch, job builder by device and pool
    # size, meta the export writes, extra leaves the export drops)
    configs = {
        "vad": lambda d, small=False: recipes.vad_job(
            batch=8, dur_s=4.0, lr=1e-3, seed=7, arch="conv",
            example_fn=partial(mc.make_vad_example_mc,
                               channels=mc.ChannelBank(np.random.default_rng(8))),
            init_params=flat["vad"], device=d),
        "encoder-proto": lambda d, small=False: proto_job(
            spk_per_batch=12, utt_per_spk=4, lr=3e-4, seed=7,
            net=EcapaTdnn(**enc_cfg), init_params=flat["encoder-proto"],
            pool_speakers=4 if small else 24, pool_utts=1 if small else 4,
            channel_kwargs={"snr_db": (8.0, 30.0)}, device=d),
        "segmentation": lambda d, small=False: recipes.segmentation_job(
            steps=1500, batch=8, lr=2e-3, seed=7, init_params=flat["segmentation"],
            example_fn=partial(mc.make_segmentation_example_mc,
                               channels=mc.ChannelBank(np.random.default_rng(8))),
            overlap_weight=2.0, device=d, **seg_kw),
        "gtcrn": lambda d, small=False: recipes.gtcrn_job(
            batch=8, dur_s=2.0, lr=5e-4, seed=7, init_params=flat["gtcrn"],
            batch_fn=partial(mc.make_noisy_clean_batch_mc,
                             channels=mc.ChannelBank(np.random.default_rng(8))),
            device=d),
        "ecapa_train_step": lambda d, small=False: StepJob(d),
    }
    k2_shape = {"vad": (8, 64000), "encoder-proto": (48, 48000),
                "segmentation": (8, 80000), "ecapa_train_step": (16, 32000)}
    out, k2_rows, failed = {}, {}, []
    tmp = Path(tempfile.mkdtemp(prefix="sdtpu_train_"))
    try:
        for name, build in configs.items():
            t_cfg = time.perf_counter()
            job = build(dev)
            if name == "ecapa_train_step":
                g = np.random.default_rng(9)
                draw = lambda: make_speaker_batch(g, bank, 16, dur_s=2.0)  # noqa: E731
            else:
                draw = job.next_batch
            # step 1's batch, then five more, each taken twice by the ten steps
            batches = [draw() for _ in range(6)]
            host_s = time.perf_counter() - t_cfg
            # (3) export identity after 0 steps
            ref = load_params_npz(wdir / files[name])
            path = tmp / f"{name}.npz"
            export_inference_weights(path, job.net, getattr(job, "meta", None))
            got = load_params_npz(path)
            got.pop("classifier", None)
            same = set(got) == set(ref) and all(
                np.array_equal(got[k], ref[k]) for k in ref)
            if not same:
                failed.append(f"{name}: the export after 0 steps differs from "
                              f"{files[name]}")
            # (1) step 1 on the card against the CPU
            grads = {}
            for where, j in (("cuda", job), ("cpu", build("cpu", small=True))):
                loss = j.loss_fn(*j.batch_tensors(batches[0]))
                loss.backward()
                vec = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                                 .detach().float().reshape(-1).cpu()
                                 for p in j.state.params.values()])
                grads[where] = (loss.item(), vec.double())
                j.state.optimizer.zero_grad(set_to_none=True)
            (l_c, g_c), (l_p, g_p) = grads["cuda"], grads["cpu"]
            loss_rel = abs(l_c - l_p) / max(abs(l_p), 1e-12)
            cos = float((g_c @ g_p) / (g_c.norm() * g_p.norm()))
            grad_rel = float((g_c - g_p).abs().max() / g_p.abs().max())
            log(f"[6] {name}: step 1 card vs CPU: loss {l_c:.6f} vs {l_p:.6f} (rel "
                f"{loss_rel:.2e}, bar {TRAIN_LOSS_REL:g}), gradient cos {cos:.8f} "
                f"(bar {TRAIN_GRAD_COS}), max diff {grad_rel:.2e} of the largest "
                f"(bar {TRAIN_GRAD_REL.get(name, 1e-3):g}), {g_c.numel()} values; {smi}")
            if not (loss_rel <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
                    and grad_rel <= TRAIN_GRAD_REL.get(name, 1e-3)):
                failed.append(f"{name}: the card's step disagrees with the CPU")
            # (2) ten steps after a warm-up, the checkpoint after step 5
            tensors = [job.batch_tensors(b) for b in batches]
            tensors += tensors[1:]
            flops = train_step_flops(job.loss_fn, tensors[0])
            losses = [apply_step(job.state, job.loss_fn, *tensors[0])]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            kernels.reset_launches()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(10)]
            for i in range(1, 11):
                ev[i - 1][0].record()
                losses.append(apply_step(job.state, job.loss_fn, *tensors[i]))
                ev[i - 1][1].record()
            torch.cuda.synchronize()
            shapes = {k: v / 10 for k, v in kernels.LAUNCH_SHAPES.items()}
            step_ms = [a.elapsed_time(b) for a, b in ev]
            peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
            losses = [float(x) for x in losses]
            # K2 is not counted here: on the card it is no product the counter
            # sees (its own bound is in the K2 rows)
            bound_ms = 1e3 * 3 * flops / PEAK_FLOPS["f32"]
            # busy share over two profiled steps
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for i in (9, 10):
                    apply_step(job.state, job.loss_fn, *tensors[i])
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            busy = sum(kernel_times_us(prof).values()) / wall_us
            med = float(np.median(step_ms))
            log(f"[6] {name}: step median {med:.3f} ms "
                f"(steps {[round(s, 2) for s in step_ms]}), float32 bound "
                f"{bound_ms:.3f} ms (3 x {flops / 1e9:.2f} GFLOP forward / 67 TFLOP/s), "
                f"peak memory {peak_gb:.3f} GB above the resident set, busy "
                f"{100 * busy:.1f} % of two profiled steps, K2 launches a step "
                f"{shapes}, host batch draw "
                f"{host_s:.1f} s for 6 batches; losses {[round(x, 5) for x in losses]}; "
                f"{smi}")
            if not all(np.isfinite(losses)):
                failed.append(f"{name}: a non-finite loss")
            k2_want = {"vad": 1, "encoder-proto": 1, "segmentation": 1,
                       "ecapa_train_step": 1, "gtcrn": 0}[name]
            if sum(v for k, v in shapes.items() if k.startswith("fused_log_mel")) != k2_want:
                failed.append(f"{name}: K2 launches a step {shapes}, expected {k2_want}")
            if any(k.startswith("asp_grid_stats") for k in shapes):
                failed.append(f"{name}: K1 (no backward) ran in training")
            # (4) the checkpoint, in a run of its own under deterministic
            # algorithms (cuDNN's default weight gradients add in no fixed
            # order): steps 1-5, saved, step 6; a fresh job restored from the
            # file takes step 6 to the same loss (the parameters) and, after
            # its update, the same leaves (the moments and the schedule's
            # count too)
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                whole = build(dev, small=True)
                for i in range(5):
                    apply_step(whole.state, whole.loss_fn, *tensors[i])
                save_train_state(tmp / f"{name}.pt", whole.state)
                ref6 = float(apply_step(whole.state, whole.loss_fn, *tensors[5]))
                fresh = build(dev, small=True)
                restore_train_state(tmp / f"{name}.pt", fresh.state)
                restored_at = fresh.state.step
                resumed = float(apply_step(fresh.state, fresh.loss_fn, *tensors[5]))
            finally:
                torch.use_deterministic_algorithms(False)
            differ = {k: float((fresh.state.params[k] - v).abs().max())
                      for k, v in whole.state.params.items()
                      if not torch.equal(fresh.state.params[k], v)}
            log(f"[6] {name}: restored after step {restored_at}, step 6 loss "
                f"{resumed!r} vs uninterrupted {ref6!r}; leaves after the "
                f"update differing from the uninterrupted run's: {len(differ)} "
                f"of {len(whole.state.params)} {dict(list(differ.items())[:5])}")
            if restored_at != 5 or resumed != ref6 or differ:
                failed.append(f"{name}: the restored run's step 6 differs")
            out[name] = {"step_ms": med, "steps_ms": step_ms, "bound_ms": bound_ms,
                         "fwd_gflop": flops / 1e9, "peak_gb": peak_gb, "busy": busy,
                         "loss_rel": loss_rel, "grad_cos": cos, "grad_rel": grad_rel,
                         "losses": losses, "k2_shapes": shapes,
                         "seconds": time.perf_counter() - t_cfg}
            if name in k2_shape:
                y = tensors[0][0].reshape(-1, tensors[0][0].shape[-1])
                assert tuple(y.shape) == k2_shape[name], y.shape
                k2_rows[name] = k2_measure(y, y.numel(), n_mels=40)
                k2_rows[name]["launches_per_step"] = sum(
                    v for k, v in shapes.items() if k.startswith("fused_log_mel"))
                r = k2_rows[name]
                log(f"[6] K2 at {name}'s {list(y.shape)}: {r['ms']:.4f} ms, plain "
                    f"{r['plain_ms']:.4f} ms, torch.stft {r['library_ms']:.4f} ms, "
                    f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max err "
                    f"{r['max_abs_err']:.2e} (tol {r['tol']:.2e}); {smi}")
                if not r["max_abs_err"] <= r["tol"]:
                    failed.append(f"K2 disagrees at {name}'s geometry")
            del job, whole, fresh, tensors
            torch.cuda.empty_cache()

        # the exports in the pipeline: the 60 s bench draw (VAD, encoder,
        # detector) and a 60 s draw in white noise at 10 dB (GTCRN), against
        # the shipped files.  The recipe writes no bisection calibration
        # (scripts/calibrate_bisect.py adds it after training, as in the JAX
        # package), so the exported encoder takes the shipped one's.
        shipped = load_speaker_encoder(wdir / files["encoder-proto"],
                                       dtype=torch.bfloat16).to(dev).eval()
        exported = load_speaker_encoder(tmp / "encoder-proto.npz",
                                        dtype=torch.bfloat16).to(dev).eval()
        exported.refine_sub_cos = shipped.refine_sub_cos
        segs = {}
        wave, truth = make_conversation(np.random.default_rng(0), 60.0, n_speakers=3, sr=SR)
        noisy, ntruth = make_conversation_heldout(np.random.default_rng(0), 60.0,
                                                  n_speakers=3, sr=SR, snr_db=10.0,
                                                  noise_kind="white")
        for tag, enc_, vad_, seg_w, gt_w in (
                ("shipped", shipped, load_vad(wdir / files["vad"]),
                 wdir / files["segmentation"], wdir / files["gtcrn"]),
                ("exported", exported, load_vad(tmp / "vad.npz"),
                 tmp / "segmentation.npz", tmp / "gtcrn.npz")):
            cfg = dataclasses.replace(bench_cfg(True, enhance=EnhanceConfig(
                weights=str(gt_w))), overlap=OverlapConfig(weights=str(seg_w)))
            pipe = DiarizationPipeline(cfg, encoder=enc_, vad=vad_.to(dev).eval())
            segs[tag] = (pipe((wave, SR)).segments, pipe((noisy, SR)).segments)
        for i, (draw, tr) in enumerate((("bench 60 s", truth), ("white10 60 s", ntruth))):
            a, b = segs["shipped"][i], segs["exported"][i]
            eq = (len(a) == len(b) and np.array_equal(a.starts, b.starts)
                  and np.array_equal(a.ends, b.ends) and np.array_equal(a.spks, b.spks))
            log(f"[6] exports in the pipeline, {draw}: {len(b)} segments vs "
                f"{len(a)} shipped, equal {eq}, DER {der_pct(tr, b):.4f} %")
            if not eq:
                failed.append(f"the exported weights give other segments on the "
                              f"{draw} draw")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[6] training phase took {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("[6] " + "; ".join(failed))
    return {"configs": out, "k2": k2_rows}


# sliding mean: largest difference between two float32 computations of it,
# relative to the input's largest magnitude (a float32 prefix sum over
# 6,400 frames; tests/test_torch_sliding.py measures 7e-7 between the
# port's and the JAX package's on the CPU)
SLIDING_TOL_REL = 4e-6
# the trunk with se_win 1201 on the card against the CPU, float32, TF32 off
# (max abs error over the output, relative to its peak): cuDNN's float32
# convolutions sum in another order than the CPU's
TRUNK_TOL_REL = 1e-4
# tests/test_webui.py's sliders (vad on/off/min-speech/min-silence/pad, SCD
# threshold, clustering, max speakers, merge gap, max turn, min cosine,
# frame reassignment)
UI_SLIDERS = (0.5, 0.35, 250, 100, 30, 1.5, "ahc", 6, 0.5, 30.0, 0.8, True)


# phase 7g's bars, card against the CPU: the reference's log-mel bar
# (tests/test_pallas_fbank.py:21), and phase 5's VAD-probability and grid
# bars (the whole-file path's grid, at the 4 s margin there)
CALL_FORM_LOGMEL_ATOL = 2e-3
CALL_FORM_VAD_ATOL = 1e-3
CALL_FORM_GRID_COS = 0.9999
# phase 7g's chunking of the conv VAD: 10 s chunks 0.5 s apart, two a call
CALL_FORM_CHUNKING = dict(chunk_s=10.0, overlap_s=0.5, group=2)


def call_forms_step(dev, wave, enc_dev, enc_cpu, vad_dev, vad_cpu) -> dict:
    """Phase 7g: the JAX call forms that the port takes since ROADMAP F27,
    on the card against the CPU, on ``wave`` (the bench 60 s draw): the
    uncentred log-mel; the conv VAD through ``chunked_framewise`` at
    :data:`CALL_FORM_CHUNKING`, whose ``[2, 160000]`` rows at a stride of
    152,000 are a K2 ``[B, T]`` geometry no other phase runs (held against
    the plain version first, not counted); the streaming grid at a 2 s
    margin (K1 and K2 ``[T]`` at the shorter chunk).  Returns the
    differences with their bars, the K2 measurement, and the launches of
    the VAD and grid runs by kernel and by shape."""
    import torch
    import torch.nn.functional as F

    from speech_diarization_tpu_torch.config import ResegConfig
    from speech_diarization_tpu_torch.dsp.mel import log_mel_spectrogram
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.pipelines.chunking import chunked_framewise
    from speech_diarization_tpu_torch.segment import embed_windows_streaming

    out = {}
    reseg = ResegConfig()
    y_cpu = torch.from_numpy(np.ascontiguousarray(wave, np.float32))
    y_dev = y_cpu.to(dev)
    chunk = int(CALL_FORM_CHUNKING["chunk_s"] * SR)
    stride = chunk - int(CALL_FORM_CHUNKING["overlap_s"] * SR)
    group = CALL_FORM_CHUNKING["group"]
    n_chunks = -(-(len(wave) - chunk) // stride) + 1
    k2_key = (f"fused_log_mel [B, T] rows of {chunk} at a stride of {stride}, "
              f"{vad_dev.net.n_mels} mels")
    with torch.inference_mode():
        lm = [log_mel_spectrogram(y, n_mels=40, center=False).cpu()
              for y in (y_dev, y_cpu)]
        rows = F.pad(y_dev, (0, (n_chunks - 1) * stride + chunk - len(wave))
                     ).unfold(0, chunk, stride)[:group]
        out["k2"] = k2_measure(rows, (group - 1) * stride + chunk,
                               n_mels=vad_dev.net.n_mels)
    diffs = {"log-mel center=False": ((lm[0] - lm[1]).abs().max().item(),
                                      CALL_FORM_LOGMEL_ATOL)}
    kernels.reset_launches()
    t0 = time.perf_counter()
    with torch.inference_mode():
        p_dev = chunked_framewise(vad_dev.probs, y_dev, SR, 160, **CALL_FORM_CHUNKING)
        g_dev = embed_windows_streaming(enc_dev, y_dev, SR, reseg.win_s,
                                        reseg.hop_s, margin_s=2.0)
        p_dev, g_dev = p_dev.cpu(), g_dev.float().cpu()
    out["wall_card_s"] = time.perf_counter() - t0
    out["launches"] = dict(kernels.LAUNCHES)
    out["shapes"] = dict(kernels.LAUNCH_SHAPES)
    t0 = time.perf_counter()
    with torch.inference_mode():
        p_cpu = chunked_framewise(vad_cpu.probs, y_cpu, SR, 160, **CALL_FORM_CHUNKING)
        g_cpu = embed_windows_streaming(enc_cpu, y_cpu, SR, reseg.win_s,
                                        reseg.hop_s, margin_s=2.0).float()
    out["wall_cpu_s"] = time.perf_counter() - t0
    diffs["VAD probs through chunked_framewise"] = (
        (p_dev - p_cpu).abs().max().item(), CALL_FORM_VAD_ATOL)
    cos = torch.nn.functional.cosine_similarity(g_dev, g_cpu, dim=1).min().item()
    out["diffs"], out["grid_min_cos"] = diffs, cos
    out["k2"]["launches"] = out["shapes"].get(k2_key, 0)
    want_k2 = -(-n_chunks // group)
    m = out["k2"]
    log(f"[7g] K2 {k2_key}: max_abs_err {m['max_abs_err']:.3e} (tol {m['tol']:.3e}), "
        f"{m['ms']:.4f} ms (plain {m['plain_ms']:.4f}, bound {m['bound_ms']:.4f} by "
        f"{m['bound_by']}, torch.stft {m['library_ms']:.4f}); {m['launches']} "
        f"launches in the VAD run (want {want_k2})")
    for k, (d, bar) in diffs.items():
        log(f"[7g] {k}, card vs CPU: max difference {d:.3e} (bar {bar:.1e})")
    log(f"[7g] grid at margin_s=2.0: {tuple(g_dev.shape)}, min cos card vs CPU "
        f"{cos:.6f} (bar {CALL_FORM_GRID_COS}); card {out['wall_card_s']:.3f} s, "
        f"CPU {out['wall_cpu_s']:.3f} s; launches {out['launches']} {out['shapes']}")
    if not (np.isfinite(lm[0].numpy()).all() and np.isfinite(p_dev.numpy()).all()
            and np.isfinite(g_dev.numpy()).all()
            and g_dev.shape == g_cpu.shape and p_dev.shape == (len(wave) // 160 + 1,)):
        raise AssertionError("[7g] an output is not finite or has another shape")
    if not m["max_abs_err"] <= m["tol"]:
        raise AssertionError(f"[7g] K2 at {k2_key} disagrees with its plain version")
    if not all(d <= bar for d, bar in diffs.values()) or not cos > CALL_FORM_GRID_COS:
        raise AssertionError("[7g] a call form on the card disagrees with the CPU")
    if m["launches"] != want_k2 or not all(out["launches"][k] for k in K12):
        raise AssertionError(f"[7g] launches {out['launches']} {out['shapes']}: "
                             f"want {want_k2} of {k2_key} and K1")
    return out


def surface_phase(dev, enc) -> dict:
    """Phase 7: the single-card public surface.  (a) every name of every
    subpackage's ``__all__`` imports; (b) the CLI's ``diarize`` on a
    ``.flac`` decoded by stub ``ffmpeg`` / ``ffprobe`` executables put first
    on ``PATH`` (the stub ffmpeg writes the bench 60 s draw, as the WAV
    holds it, as f32le; the same stub on every machine, and soundfile kept
    out of the chain, so the run is the same everywhere): its RTTM equal to
    the ``.wav`` run's, K1 and K2 launched; (c) the cumsum sliding mean on
    the card: against the banded form at ``win`` 1025 on log-mel features
    and trunk activations of 6,400 frames, against the CPU at 1201 and
    2001, and the trunk with ``se_win=1201`` against the CPU; (d) bench
    milestones 3.5 and 5 through ``scripts/torch_bench.py``'s functions;
    (e) the web UI's slider config on ``make_tone_conversation(0)``, the
    pipeline on the card against the CPU; (f) ``Profiler.trace`` around a
    60 s pipeline call, its trace naming both kernels; (g) the JAX call
    forms of ROADMAP F27 on the card against the CPU
    (:func:`call_forms_step`).  Returns the launches by kernel over (b),
    (e), (f) and (g) and the measurements."""
    import importlib
    import importlib.util
    import os
    import pkgutil
    import tempfile

    import torch

    import speech_diarization_tpu_torch as port
    from speech_diarization_tpu_torch import cli, webui
    from speech_diarization_tpu_torch.config import DiarizationConfig
    from speech_diarization_tpu_torch.dsp.mel import fused_log_mel
    from speech_diarization_tpu_torch.io.audio import read_wav, write_wav
    from speech_diarization_tpu_torch.models.layers import sliding_mean_time
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.synthetic import (
        make_conversation, make_tone_conversation,
    )
    from speech_diarization_tpu_torch.utils.profiling import Profiler

    t_phase = time.perf_counter()
    out = {"launches": {k: 0 for k in kernels.LAUNCHES}, "launches_by_run": {}}

    def counted(tag, fn):
        kernels.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        out["launches_by_run"][tag] = dict(kernels.LAUNCHES)
        for k, v in kernels.LAUNCHES.items():
            out["launches"][k] += v
        if not all(kernels.LAUNCHES[k] for k in K12):
            raise AssertionError(f"[7] {tag}: a kernel was not launched: "
                                 f"{kernels.LAUNCHES}")
        return res

    # (a) exports
    n_names = len(port.__all__)
    for m in pkgutil.iter_modules(port.__path__):
        if m.ispkg:
            mod = importlib.import_module(f"{port.__name__}.{m.name}")
            for name in getattr(mod, "__all__", ()):
                getattr(mod, name)
                n_names += 1
    log(f"[7a] {n_names} exported names of the port and its subpackages import")

    # (b) non-WAV decode through the stub ffmpeg, on the card
    wave60, _ = make_conversation(np.random.default_rng(0), 60.0, n_speakers=3,
                                  sr=SR)
    path_env, sf = os.environ.get("PATH", ""), sys.modules.get("soundfile")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        wav = tmp / "wav" / "x.wav"
        write_wav(wav, wave60, SR)
        raw = tmp / "x.f32"
        raw.write_bytes(read_wav(wav)[0][0].astype("<f4").tobytes())
        (tmp / "bin").mkdir()
        (tmp / "bin" / "ffmpeg").write_text(f"#!/bin/sh\ncat '{raw}'\n")
        (tmp / "bin" / "ffprobe").write_text("#!/bin/sh\necho 16000,1\n")
        for name in ("ffmpeg", "ffprobe"):
            (tmp / "bin" / name).chmod(0o755)
        flac = tmp / "flac" / "x.flac"
        flac.parent.mkdir()
        flac.write_bytes(b"fLaC")
        os.environ["PATH"] = f"{tmp / 'bin'}{os.pathsep}{path_env}"
        sys.modules["soundfile"] = None
        try:
            rttm = {}
            for kind, src in (("wav", wav), ("flac", flac)):
                od = tmp / f"out_{kind}"
                argv = ["diarize", str(src), "--out-dir", str(od), "--format", "rttm"]
                t0 = time.perf_counter()
                rc = (counted("cli_flac", lambda: cli.main(argv)) if kind == "flac"
                      else cli.main(argv))
                if rc != 0:
                    raise AssertionError(f"[7b] cli diarize {src.name}: exit {rc}")
                rttm[kind] = (od / "x.rttm").read_text().splitlines()
                log(f"[7b] sdtpu-torch diarize {src.name} on the card: "
                    f"{time.perf_counter() - t0:.2f} s, {len(rttm[kind])} RTTM lines")
        finally:
            os.environ["PATH"] = path_env
            if sf is None:
                sys.modules.pop("soundfile", None)
            else:
                sys.modules["soundfile"] = sf
    log(f"[7b] .flac through the stub ffmpeg: RTTM equal to the .wav run's: "
        f"{rttm['flac'] == rttm['wav']}; launches "
        f"{out['launches_by_run']['cli_flac']}")
    if not rttm["wav"] or rttm["flac"] != rttm["wav"]:
        raise AssertionError("[7b] the .flac run's RTTM differs from the .wav run's")

    # (c) the cumsum sliding mean on the card
    enc32 = load_speaker_encoder(HERE / "weights" / "ecapa_robust_stream.npz")
    y64 = torch.from_numpy(np.clip(make_conversation(
        np.random.default_rng(2), 64.0, n_speakers=3, sr=SR)[0], -0.99, 0.99)).to(dev)
    with torch.inference_mode():
        feats = fused_log_mel(y64, n_mels=40)[:6400]              # [6400, 40]
        net_c = enc32.net.to(dev)
        trunk_c = net_c.trunk(feats[None])                         # [1, 768, T]
    rows = {"log-mel [1, 40, 6400]": feats.T[None].contiguous(),
            "trunk [1, 256, 6400]": trunk_c[:, :256].float().contiguous()}
    sliding = {}
    for tag, x in rows.items():
        bar = SLIDING_TOL_REL * x.abs().max().item()
        d = (sliding_mean_time(x, 1025, "cumsum")
             - sliding_mean_time(x, 1025, "banded")).abs().max().item()
        sliding[f"{tag} win 1025 cumsum vs banded"] = (d, bar)
        for win in (1201, 2001):
            d = (sliding_mean_time(x, win).cpu()
                 - sliding_mean_time(x.cpu(), win)).abs().max().item()
            sliding[f"{tag} win {win} card vs CPU"] = (d, bar)
    with torch.inference_mode():
        t_card = net_c.trunk(feats[None], se_win=1201).cpu()
        net_p = load_speaker_encoder(HERE / "weights" / "ecapa_robust_stream.npz").net
        t_cpu = net_p.trunk(feats[None].cpu(), se_win=1201)
    sliding["trunk se_win 1201 card vs CPU"] = (
        (t_card - t_cpu).abs().max().item(),
        TRUNK_TOL_REL * t_cpu.abs().max().item())
    for k, (d, bar) in sliding.items():
        log(f"[7c] {k}: max difference {d:.3e} (bar {bar:.3e})")
    if not all(d <= bar for d, bar in sliding.values()):
        raise AssertionError("[7c] a sliding-mean difference is over its bar")
    out["sliding"] = sliding

    # (d) bench milestones 3.5 and 5
    spec = importlib.util.spec_from_file_location(
        "torch_bench", HERE / "scripts" / "torch_bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    out["mfu"] = bench.mfu_micro_bench(enc)
    out["fbank"] = bench.fbank_micro_bench()
    log(f"[7d] milestone 3.5: {out['mfu']}")
    log(f"[7d] milestone 5: {out['fbank']}")

    # (e) the web UI's compute on the card
    cfg = webui._ui_config(*UI_SLIDERS)
    tone, _ = make_tone_conversation(0)
    y_ui, sr = webui.normalize_gradio_audio((SR, (tone * 32767).astype(np.int16)))
    segs = {"cuda": counted("webui", lambda: DiarizationPipeline(cfg)((y_ui, sr)))
            .segments,
            "cpu": DiarizationPipeline(cfg, device="cpu")((y_ui, sr)).segments}
    same = (len(segs["cuda"]) == len(segs["cpu"]) and all(
        np.array_equal(getattr(segs["cuda"], f), getattr(segs["cpu"], f))
        for f in ("starts", "ends", "spks")))
    log(f"[7e] web UI config on the tone conversation: {len(segs['cuda'])} "
        f"segments on the card, {len(segs['cpu'])} on the CPU, equal: {same}; "
        f"launches {out['launches_by_run']['webui']}")
    if not same:
        raise AssertionError("[7e] the web UI's segments on the card differ "
                             "from the CPU's")

    # (f) Profiler.trace around one 60 s pipeline call
    pipe = DiarizationPipeline(DiarizationConfig(), encoder=enc)
    pipe((wave60, SR))
    prof = Profiler()
    with tempfile.TemporaryDirectory() as tmp:
        with prof.trace(tmp):
            with prof.span("diarize 60 s"):
                counted("trace", lambda: pipe((wave60, SR)))
        trace = (Path(tmp) / "trace.json").read_text()
        kb = len(trace) // 1024
    named = {k: k in trace for k in ("asp_preproj_kernel", "asp_window_kernel",
                                     "fused_log_mel_kernel")}
    log(f"[7f] Profiler.trace of a 60 s call ({prof.report()['diarize 60 s']['total_s']:.3f} "
        f"s under the profiler): {kb} KiB, kernels named {named}")
    if not all(named.values()):
        raise AssertionError("[7f] the trace does not name both kernels")

    # (g) the JAX call forms of ROADMAP F27 on the card against the CPU
    out["call_forms"] = call_forms_step(
        dev, wave60, enc32.to(dev).eval(),
        load_speaker_encoder(HERE / "weights" / "ecapa_robust_stream.npz"),
        load_vad(HERE / "weights" / "vad_conv_mc.npz").to(dev).eval(),
        load_vad(HERE / "weights" / "vad_conv_mc.npz").eval())
    for k, v in out["call_forms"]["launches"].items():
        out["launches"][k] += v
    out["wall"] = time.perf_counter() - t_phase
    log(f"[7] surface phase took {out['wall']:.1f} s; launches {out['launches']}")
    return out


# DER (%) of the JAX corpus's sharded route on the CPU (eight virtual
# devices) on the 60 s bench draw: the bf16 ecapa_robust_stream.npz as the
# encoder to shard, vad_conv_mc.npz, the windowed grid (--sharded of
# scripts/torch_port_der_bar.py)
JAX_CPU_DER_PCT_SHARDED = 1.3439
# the sharded encoder against the single-device one, atol and rtol
# (tests/test_sharded_inference.py:40)
SHARDED_TOL = 1e-4
# phase 8d's mesh step medians (ms) before the cross-shard gradient sums
# were made in rank order (virtual meshes of an NVIDIA H100 80GB HBM3 at
# 700 W; host-bound: medians spread 20-40 % between runs), logged beside
# this run's
MESH_STEP_MS_BEFORE = {"ecapa_train_step": 78.491, "gtcrn": 107.917}


def parallel_phase(dev, smi, enc, vad, bench_cfg, der_pct, cards=None) -> dict:
    """Phase 8: ROADMAP item 7 on virtual meshes of the one card (a mesh
    that names ``dev`` several times), or on the first of ``cards`` (real
    devices, at least 4; ``scripts/torch_mesh_cards.py``).  (a) ``make_sharded_encode_fn`` with
    the float32 ``ecapa_robust_stream.npz`` on the windowed grid's
    ``[512, 32000]`` batch (a view at a row stride of 1,600) at dp 2, dp 4
    and dp 2 x tp 2 (``mfa``, ``fc_w`` split) against the single-device
    ``encode_batch`` (atol / rtol ``SHARDED_TOL``), one K2 launch a shard by
    shape, times against the single-device call, and K2 at each shard's
    geometry against its plain version; (b) ``corpus_diarize`` on one file
    with two devices and ``encode_model`` (the sharded route) on the 60 s
    and 600 s bench draws: segments equal to the single-device windowed
    grid with the same encoder (as a bare encode function: no calibrated
    refine threshold), DER on 60 s within one point of
    ``JAX_CPU_DER_PCT_SHARDED``, walls beside the single-device run's;
    (c) bench milestone 4 at dp 2 (``torch_bench.sharded_asp_check``):
    min cosine above 0.9999, K1 twice; (d) ``make_ecapa_train_step`` at
    phase 6's width (16 x 2 s, train-mode BN, 64 classes) on dp 2 x tp 2
    and ``make_gtcrn_train_step`` (8 x 2 s) on dp 2: step 1 against the
    single-device step on the card (bars ``TRAIN_*``), the median of ten
    steps beside the single-device median, K2 launches a step by shape, and
    each mesh step resumed under deterministic algorithms (``mesh_resume``:
    the restored step 3, and step 3 repeated with its threads reassigned,
    bitwise equal to the uninterrupted one); (e) ``dryrun_multichip(2)``
    and ``(4)``.  Returns the measurements and the launches by kernel over
    the phase's runs."""
    import copy
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from speech_diarization_tpu_torch.dryrun import dryrun_multichip
    from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn
    from speech_diarization_tpu_torch.models.port import (
        load_params_meta, load_params_npz, load_speaker_encoder,
    )
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.parallel import make_mesh, make_sharded_encode_fn
    from speech_diarization_tpu_torch.pipelines.corpus import corpus_diarize
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.recipes import make_noisy_clean_batch
    from speech_diarization_tpu_torch.train.checkpoint import (
        restore_train_state, save_train_state,
    )
    from speech_diarization_tpu_torch.train.steps import (
        apply_step, make_ecapa_train_step, make_gtcrn_train_step,
    )
    from speech_diarization_tpu_torch.train.synthetic import (
        make_conversation, make_speaker_bank, make_speaker_batch,
    )

    sys.path.insert(0, str(HERE / "scripts"))
    from torch_bench import sharded_asp_check

    t_phase = time.perf_counter()
    wdir = HERE / "weights"
    out = {"launches": {k: 0 for k in kernels.LAUNCHES}, "k2": {}, "encode": {},
           "corpus": {}, "train": {}, "dryrun": {}}
    failed = []

    def counted(fn):
        kernels.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        for k, v in kernels.LAUNCHES.items():
            out["launches"][k] += v
        return res, dict(kernels.LAUNCH_SHAPES)

    def mesh_of(n, tp=1):
        return make_mesh(devices=cards[:n] if cards else [dev] * n, tp=tp)

    # (a) the sharded encoder on one encode batch of the windowed grid
    enc32 = load_speaker_encoder(wdir / "ecapa_robust_stream.npz").to(dev).eval()
    wave60, truth60 = make_conversation(np.random.default_rng(0), 60.0, n_speakers=3,
                                        sr=SR)
    y60 = torch.from_numpy(wave60).to(dev)
    wins = y60[:511 * 1600 + 32000].unfold(0, 32000, 1600)
    k2_win = "fused_log_mel [B, T] rows of 32000 at a stride of 1600, 40 mels"
    with torch.inference_mode():
        ref = enc32.encode_batch(wins)
        single_ms = cuda_time_ms(lambda: enc32.encode_batch(wins), 5)
        out["encode"]["single_ms"] = single_ms
        for tag, n, tp, pats in (("dp2", 2, 1, ()), ("dp4", 4, 1, ()),
                                 ("dp2xtp2", 4, 2, ("mfa", "fc_w"))):
            sharded = make_sharded_encode_fn(enc32, None, mesh_of(n, tp), pats)
            got, shapes = counted(lambda: sharded(wins))
            err = (got - ref).abs()
            worst = float((err / (SHARDED_TOL + SHARDED_TOL * ref.abs())).max())
            ms = cuda_time_ms(lambda: sharded(wins), 5)
            dp = n // tp
            out["encode"][tag] = {"max_abs_err": float(err.max()), "tol_used": worst,
                                  "ms": ms, "k2_shapes": shapes,
                                  "split": sorted(sharded._split[0])}
            log(f"[8a] sharded encoder {tag} on [512, 32000] (float32, C 256): max "
                f"abs diff {float(err.max()):.3e} from one device ({worst:.3f} of "
                f"atol/rtol {SHARDED_TOL:g}); {ms:.3f} ms vs {single_ms:.3f} ms on "
                f"one device; K2 launches {shapes}; {len(sharded._split[0])} "
                f"leaves split; {smi}")
            if not worst <= 1.0:
                failed.append(f"the sharded encoder {tag} differs from one device")
            # a shard on another card is a contiguous copy there
            rows = sum(v for k, v in shapes.items()
                       if k.startswith("fused_log_mel [B, T] rows of 32000 at"))
            if rows != dp or sum(shapes.values()) != dp or (
                    not cards and shapes != {k2_win: dp}):
                failed.append(f"{tag}: K2 launches {shapes}, expected {dp} of {k2_win}")
        for dp in (2, 4):
            rows_ = 512 // dp
            k2 = k2_measure(wins[:rows_], (rows_ - 1) * 1600 + 32000)
            out["k2"][f"encode_dp{dp}"] = k2
            if not k2["max_abs_err"] <= k2["tol"]:
                failed.append(f"K2 disagrees at the dp {dp} shard")

    # (b) the corpus's sharded route on one file and two devices
    cfg = bench_cfg(True)
    bare = copy.deepcopy(enc)        # the encoder as a bare encode function
    bare.streaming_trained, bare.refine_sub_cos = False, None
    single = DiarizationPipeline(cfg, encoder=bare, vad=vad)
    # the route's pipeline kept warm: its wall without the corpus's set-up
    lone = DiarizationPipeline(cfg, encoder=make_sharded_encode_fn(
        enc, None, mesh_of(2)), vad=vad)
    wave600, truth600 = make_conversation(np.random.default_rng(0), 600.0,
                                          n_speakers=3, sr=SR)
    for dur, wave, truth in ((60, wave60, truth60), (600, wave600, truth600)):
        res1 = single((wave, SR))
        lone((wave, SR))
        walls1, walls2 = [], []
        for _ in range(2):
            for pipe_, walls in ((single, walls1), (lone, walls2)):
                t0 = time.perf_counter()
                pipe_((wave, SR))
                walls.append(time.perf_counter() - t0)
        reports = []
        for _ in range(2):
            rep, shapes = counted(lambda: corpus_diarize(
                [(wave, SR)], cfg, devices=list(mesh_of(2).devices.flat),
                encode_model=enc, vad=vad, keep_results=True))
            reports.append(rep)
        rep = reports[0]
        entry = rep.files[0] if rep.files else {}
        segs = entry["result"].segments if entry else None
        same = segs is not None and (
            len(segs) == len(res1.segments)
            and np.allclose(segs.starts, res1.segments.starts, atol=1e-6)
            and np.allclose(segs.ends, res1.segments.ends, atol=1e-6)
            and np.array_equal(segs.spks, res1.segments.spks))
        der = der_pct(truth, segs) if segs is not None else float("nan")
        wall2 = min(r.files[0]["wall_s"] for r in reports if r.files)
        out["corpus"][dur] = {"device": entry.get("device"), "segments": len(segs or []),
                              "equal": same, "der_pct": der, "wall_sharded_s": wall2,
                              "wall_single_s": min(walls1),
                              "wall_sharded_warm_s": min(walls2), "k2_shapes": shapes,
                              "errors": rep.errors}
        bar = f" (bar {JAX_CPU_DER_PCT_SHARDED} +- {DER_SLACK_PCT})" if dur == 60 else ""
        log(f"[8b] corpus, one {dur} s file on two devices: route "
            f"{entry.get('device')}, {len(segs or [])} segments, equal to one "
            f"device's windowed grid {same}, DER {der:.4f} %{bar}; file wall "
            f"{wall2:.4f} s in the corpus (its pipeline new), {min(walls2):.4f} s "
            f"warm, vs {min(walls1):.4f} s on one device; K2 "
            f"{shapes}; {smi}")
        if rep.errors or entry.get("device") != "sharded[2]" or not same:
            failed.append(f"the sharded corpus route on {dur} s: {rep.errors or entry.get('device')}, "
                          f"equal {same}")
        if dur == 60 and not abs(der - JAX_CPU_DER_PCT_SHARDED) <= DER_SLACK_PCT:
            failed.append(f"the sharded route's DER {der:.4f} % is off the JAX bar")

    # (c) bench milestone 4: K1 under sharding at dp 2
    with torch.inference_mode():
        (sh, _) = counted(lambda: sharded_asp_check(
            enc, devices=list(mesh_of(2).devices.flat)))
    out["asp"] = sh
    log(f"[8c] K1 under sharding: {sh}; {smi}")

    # (d) the mesh training steps against one device
    meta = load_params_meta(wdir / "ecapa_robust_stream.npz")["net"]
    enc_cfg = dict(meta, dilations=tuple(meta["dilations"]))
    cls = np.random.default_rng(0).standard_normal((64, enc_cfg["emb_dim"])) \
        .astype(np.float32) * 0.05
    ecapa_flat = {**load_params_npz(wdir / "ecapa_robust_stream.npz"), "classifier": cls}
    gtcrn_flat = load_params_npz(wdir / "gtcrn_mc.npz")
    bank = make_speaker_bank(np.random.default_rng(8), 64)
    g = np.random.default_rng(9)
    e_batches = [make_speaker_batch(g, bank, 16, dur_s=2.0) for _ in range(6)]
    g = np.random.default_rng(10)
    g_batches = [make_noisy_clean_batch(g, 8, 2.0) for _ in range(6)]

    def ecapa(where):
        init_fn, step_fn, shard = make_ecapa_train_step(where, EcapaTdnn(**enc_cfg), 64)
        state = shard(init_fn(params=ecapa_flat))
        return state, lambda *b: step_fn.loss_fn(state.params, *b), step_fn.replicas

    def gtcrn(where):
        init_fn, step_fn = make_gtcrn_train_step(where)
        return init_fn(params=gtcrn_flat), step_fn.loss_fn, step_fn.replicas

    def mesh_resume(name, build, batches, where, tmp):
        """Under deterministic algorithms (cuDNN's default weight gradients
        add in no fixed order): steps 1-2, saved, step 3; a fresh job
        restored from the file takes step 3; then the first job, restored
        in place, takes step 3 again from a new thread with its shard
        threads reversed (ECAPA's; GTCRN's shards run in turn on the
        calling thread).  Returns the steps' losses and the leaves that
        differ from the uninterrupted run's, bitwise."""
        tensors = [tuple(torch.as_tensor(a).to(dev) for a in b) for b in batches[:3]]
        path = tmp / f"{name}_mesh.pt"
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            whole, loss_fn, reps = build(where)
            for i in range(2):
                apply_step(whole, loss_fn, *tensors[i])
            save_train_state(path, whole)
            ref = float(apply_step(whole, loss_fn, *tensors[2]))
            want = {k: p.detach().clone() for k, p in whole.params.items()}
            fresh, fresh_loss, _ = build(where)
            restore_train_state(path, fresh)
            got = {"restored": (float(apply_step(fresh, fresh_loss, *tensors[2])),
                                fresh)}
            del fresh, fresh_loss
            restore_train_state(path, whole)
            if name == "ecapa_train_step":
                reps.workers.reassign(list(range(len(reps.devices)))[::-1])
            with ThreadPoolExecutor(1) as other:
                loss = other.submit(apply_step, whole, loss_fn, *tensors[2]).result()
            got["reassigned"] = (float(loss), whole)
        finally:
            torch.use_deterministic_algorithms(False)
        return ref, len(want), {how: (loss, [k for k, v in want.items()
                                             if not torch.equal(state.params[k].detach(), v)])
                                for how, (loss, state) in got.items()}

    for name, build, batches, where in (("ecapa_train_step", ecapa, e_batches, mesh_of(4, 2)),
                                        ("gtcrn", gtcrn, g_batches, mesh_of(2))):
        res = {}
        for tag, w in (("single", dev), ("mesh", where)):
            state, loss_fn, _ = build(w)
            tensors = [tuple(torch.as_tensor(a).to(dev) for a in b) for b in batches]
            tensors += tensors[1:]
            loss = loss_fn(*tensors[0])
            loss.backward()
            vec = torch.cat([(p.grad if p.grad is not None else torch.zeros(p.shape))
                             .detach().float().reshape(-1).cpu()
                             for p in state.params.values()])
            state.optimizer.zero_grad(set_to_none=True)
            apply_step(state, loss_fn, *tensors[0])
            kernels.reset_launches()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(10)]
            losses = []
            for i in range(1, 11):
                ev[i - 1][0].record()
                losses.append(apply_step(state, loss_fn, *tensors[i]))
                ev[i - 1][1].record()
            torch.cuda.synchronize()
            for k, v in kernels.LAUNCHES.items():
                out["launches"][k] += v
            res[tag] = {"loss": loss.item(), "grad": vec.double(),
                        "step_ms": float(np.median([a.elapsed_time(b) for a, b in ev])),
                        "k2_shapes": {k: v / 10 for k, v in kernels.LAUNCH_SHAPES.items()},
                        "losses": [float(x) for x in losses]}
            del state, tensors
        (l_s, g_s), (l_m, g_m) = ((res[t]["loss"], res[t]["grad"]) for t in ("single", "mesh"))
        loss_rel = abs(l_m - l_s) / max(abs(l_s), 1e-12)
        cos = float((g_m @ g_s) / (g_m.norm() * g_s.norm()))
        grad_rel = float((g_m - g_s).abs().max() / g_s.abs().max())
        dp, tp = where.shape["dp"], where.shape["tp"]
        out["train"][name] = {
            "mesh": f"dp{dp}xtp{tp}", "loss_rel": loss_rel, "grad_cos": cos,
            "grad_rel": grad_rel, "step_ms_single": res["single"]["step_ms"],
            "step_ms_mesh": res["mesh"]["step_ms"],
            "k2_shapes_mesh": res["mesh"]["k2_shapes"],
            "losses_mesh": res["mesh"]["losses"]}
        log(f"[8d] {name} on dp{dp}xtp{tp} vs one device: step 1 loss {l_m:.6f} vs "
            f"{l_s:.6f} (rel {loss_rel:.2e}, bar {TRAIN_LOSS_REL:g}), gradient cos "
            f"{cos:.8f} (bar {TRAIN_GRAD_COS}), max diff {grad_rel:.2e} of the largest "
            f"(bar {TRAIN_GRAD_REL.get(name, 1e-3):g}); step median "
            f"{res['mesh']['step_ms']:.3f} ms vs {res['single']['step_ms']:.3f} ms "
            f"on one device ({MESH_STEP_MS_BEFORE[name]} ms before the rank-ordered "
            f"sums); "
            f"K2 a step {res['mesh']['k2_shapes']}; {smi}")
        k2_want = 0 if name == "gtcrn" else dp
        if not (loss_rel <= TRAIN_LOSS_REL and cos >= TRAIN_GRAD_COS
                and grad_rel <= TRAIN_GRAD_REL.get(name, 1e-3)):
            failed.append(f"{name}: the mesh step disagrees with one device")
        if sum(res["mesh"]["k2_shapes"].values()) != k2_want or not all(
                np.isfinite(res["mesh"]["losses"])):
            failed.append(f"{name}: K2 a step {res['mesh']['k2_shapes']}, expected "
                          f"{k2_want}; losses {res['mesh']['losses']}")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ref, n_leaves, resumed = mesh_resume(name, build, batches, where, Path(tmp))
        out["train"][name]["resume"] = {"loss": ref, **{
            how: {"loss": loss, "leaves_differing": len(diff)}
            for how, (loss, diff) in resumed.items()}}
        log(f"[8d] {name} on dp{dp}xtp{tp}, resumed under deterministic algorithms "
            f"({time.perf_counter() - t0:.1f} s): step 3 loss {ref!r} uninterrupted; "
            + "; ".join(f"{how} {loss!r}, leaves differing {len(diff)} of {n_leaves} "
                        f"{diff[:5]}" for how, (loss, diff) in resumed.items())
            + f"; {smi}")
        if any(loss != ref or diff for loss, diff in resumed.values()):
            failed.append(f"{name}: the mesh step 3 is not reproduced bitwise: {resumed}")
    y_tr = torch.as_tensor(e_batches[0][0]).to(dev)[:8]
    out["k2"]["train_dp2"] = k2_measure(y_tr, y_tr.numel())

    # (e) the dry run on virtual meshes of 2 and 4
    for n in (2, 4):
        t0 = time.perf_counter()
        (r, _) = counted(lambda: dryrun_multichip(n, device=dev))    # virtual
        r["wall_s"] = time.perf_counter() - t0
        out["dryrun"][n] = r
        log(f"[8e] dryrun_multichip({n}): {r}")
    out["wall"] = time.perf_counter() - t_phase
    log(f"[8] parallel phase took {out['wall']:.1f} s; launches {out['launches']}")
    if failed:
        raise AssertionError("[8] " + "; ".join(failed))
    if not all(out["launches"][k] for k in K12):
        raise AssertionError(f"[8] a kernel was not launched: {out['launches']}")
    return out


# phase 9: each evaluation tool's result on the card against the same
# function with device='cpu' in the same call: DER / JER within one point
# (the port's DER bars), VAD miss / false-alarm rates within half a point,
# detector precision / recall / F1 within 0.02, probe cosines within 1e-3
# and EER / purity within 0.02, SI-SNR within 0.05 dB, the calibration's
# sub-centroid and within-cluster cosines within 2e-3 (merged flags equal)
TOOL_BARS = {"der_pts": 1.0, "vad_pts": 0.5, "det": 0.02, "cos": 1e-3,
             "eer": 0.02, "si_snr_db": 0.05, "sub_cos": 2e-3,
             "frame_acc": 0.02}
# the kernels each tool's card run must launch (the synthetic table's probe
# encoder is numpy; its K2 launches come from the overlap detector's 5 s
# windows, which the whole-file path scores)
TOOL_KERNELS = {
    "rttm": ("asp_grid_stats", "fused_log_mel"),
    "synthetic": ("fused_log_mel",),
    "tail": ("asp_grid_stats", "fused_log_mel"),
    "calibrate": ("asp_grid_stats", "fused_log_mel"),
    "vad": ("fused_log_mel",),
    "overlap_det": ("fused_log_mel",),
    "segmentation": ("asp_grid_stats", "fused_log_mel"),
    "probe": ("asp_grid_stats", "fused_log_mel"),
    "enhancer": (),
    "grid_backends": ("asp_grid_stats", "fused_log_mel"),
}
# the probe's geometry at its defaults: 96 utterances of 2 s at 80 mels
# (ecapa_synthetic_full_stream.npz), 1 s windows at a 0.5 s hop
K2_PROBE = "fused_log_mel [B, T] rows of 32000 at a stride of 32000, 80 mels"
K1_PROBE = "asp_grid_stats A 128, CC 1536, win_f 101, hop_f 50"


def tools_phase(dev) -> dict:
    """Phase 9: the evaluation and calibration tools (``scripts/torch_*.py``)
    at small sizes, each on the card and then with ``device='cpu'``; the
    card's result held against the CPU's at :data:`TOOL_BARS`.  The K2
    batch and the K1 grid of the probe's default geometry against their
    plain versions (not counted).  Returns each tool's walls, launches by
    kernel and by shape, and the two kernel measurements."""
    import tempfile

    import torch

    from speech_diarization_tpu_torch.dsp.mel import _log_mel_1d
    from speech_diarization_tpu_torch.models.layers import sliding_mean_time
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder
    from speech_diarization_tpu_torch.ops import kernels

    sys.path.insert(0, str(HERE / "scripts"))
    import torch_calibrate_bisect
    import torch_eval_enhancer
    import torch_eval_grid_backends
    import torch_eval_overlap_det
    import torch_eval_rttm
    import torch_eval_segmentation
    import torch_eval_synthetic
    import torch_eval_tail
    import torch_eval_vad
    import torch_probe_encoder

    t_phase = time.perf_counter()
    wdir = HERE / "weights"
    out = {"tools": {}, "launches": {k: 0 for k in kernels.LAUNCHES}, "shapes": {}}

    # (a) the probe's default geometry against the plain versions
    wavs, _ = torch_probe_encoder.render(12, 8, 2.0, 123, "mixed", "off")
    full = load_speaker_encoder(wdir / "ecapa_synthetic_full_stream.npz").to(dev).eval()
    with torch.inference_mode():
        y = torch.from_numpy(wavs).to(dev)                       # [96, 32000]
        out["k2"] = k2_measure(y, y.numel(), n_mels=80)
        f = _log_mel_1d(y[0], n_mels=80)[None]
        f = f - sliding_mean_time(f.transpose(1, 2), 101).transpose(1, 2)
        x = full.net.trunk(f, se_win=101)[0]                     # [1536, 201]
        out["k1"] = k1_measure(full.net, x, 3, 0, hop_f=50, win_f=101)
    for tag, m in (("fused_log_mel [96, 32000] 80 mels", out["k2"]),
                   ("asp_grid_stats A 128 win_f 101 hop_f 50", out["k1"])):
        log(f"[9a] {tag}: max_abs_err {m['max_abs_err']:.3e} (tol {m['tol']:.3e}), "
            f"{m['ms']:.4f} ms (plain {m['plain_ms']:.4f}, bound {m['bound_ms']:.4f} "
            f"by {m['bound_by']}, library {m['library_ms']})")
        if not m["max_abs_err"] <= m["tol"]:
            raise AssertionError(f"[9a] {tag} disagrees with its plain version")

    # (b) each tool on the card, then on the CPU
    tmp = Path(tempfile.mkdtemp(prefix="sdtpu_tools_"))
    pairs = torch_eval_rttm.selftest_pairs(tmp, 1)
    seg_w = wdir / "segmentation_synthetic.npz"
    vad_w = str(wdir / "vad_conv_mc.npz")
    full_w = str(wdir / "ecapa_synthetic_full_stream.npz")
    tools = {
        "rttm": lambda d: torch_eval_rttm.run(
            pairs, device=d, vad_weights=str(wdir / "vad_synthetic.npz"))["aggregate"],
        "synthetic": lambda d: torch_eval_synthetic.evaluate(1, device=d),
        "tail": lambda d: torch_eval_tail.evaluate(seeds=(2000, 2001), device=d)[0],
        "calibrate": lambda d: torch_calibrate_bisect.calibrate(
            full_w, vad_w, dur=60.0, files=1, device=d, n_speakers=(2, 3))[0],
        "vad": lambda d: torch_eval_vad.score_weights(
            Path(vad_w), ["indomain", "heldout-white10"], 1, 60.0, 3, device=d),
        "overlap_det": lambda d: torch_eval_overlap_det.evaluate(
            None, ["heldout-overlap", "heldout-dry"], 60.0, 1, 3, device=d)[1],
        "segmentation": lambda d: {
            "frame": torch_eval_segmentation.frame_eval(seg_w, 1, 8, 0, d),
            "pipeline": torch_eval_segmentation.pipeline_eval(
                seg_w, 1, 30.0, 3, 0.3, 0, device=d, bf16=True)},
        "probe": lambda d: torch_probe_encoder.probe(full_w, device=d),
        "enhancer": lambda d: torch_eval_enhancer.evaluate(
            "gtcrn", [str(wdir / "gtcrn_mc.npz")], 4, 2.0, 1, d)["gtcrn_mc.npz"],
        "grid_backends": lambda d: torch_eval_grid_backends.evaluate(1, device=d),
    }
    failed = []
    for name, fn in tools.items():
        kernels.reset_launches()
        t0 = time.perf_counter()
        card = fn(None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, shapes = dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES)
        t0 = time.perf_counter()
        cpu = fn("cpu")
        wall_cpu = time.perf_counter() - t0
        for k, v in launches.items():
            out["launches"][k] += v
        for k, v in shapes.items():
            out["shapes"][k] = out["shapes"].get(k, 0) + v
        diffs = tool_diffs(name, card, cpu)
        off = {k: v for k, v in diffs.items() if not v[0] <= v[1]}
        missing = [k for k in TOOL_KERNELS[name] if not launches[k]]
        out["tools"][name] = {"wall_s": wall, "wall_cpu_s": wall_cpu,
                              "launches": launches, "shapes": shapes,
                              "card": card, "diffs": diffs}
        log(f"[9b] {name}: card {wall:.3f} s, CPU {wall_cpu:.3f} s; launches "
            f"{launches}; largest differences "
            f"{({k: (round(v[0], 6), v[1]) for k, v in diffs.items()})}")
        if off or missing:
            failed.append(f"{name}: off {off}, not launched {missing}")
    out["wall"] = time.perf_counter() - t_phase
    log(f"[9] tools phase took {out['wall']:.1f} s; launches {out['launches']}; "
        f"by shape {out['shapes']}")
    if failed:
        raise AssertionError("[9] " + "; ".join(failed))
    if not all(out["launches"][k] for k in K12):
        raise AssertionError(f"[9] a kernel was not launched: {out['launches']}")
    return out


def tool_diffs(name: str, card, cpu) -> dict:
    """{quantity: (|card - CPU|, bar)} of one tool's results."""
    b = TOOL_BARS
    d = {}

    def put(key, x, y, bar):
        d[key] = (abs(float(x) - float(y)), bar)

    if name == "rttm":
        for k in ("der", "miss", "fa", "conf", "jer"):
            put(k, 100 * card[k], 100 * cpu[k], b["der_pts"])
    elif name == "synthetic":
        for m in card:
            for k in ("der", "jer"):
                put(f"{m} {k}", card[m][k], cpu[m][k], b["der_pts"])
    elif name == "tail":
        for r, s in zip(card, cpu):
            put(f"seed {r['seed']} der", r["der_pct"], s["der_pct"], b["der_pts"])
            put(f"seed {r['seed']} speakers", r["spk"], s["spk"], 0)
    elif name == "calibrate":
        put("clusters", len(card), len(cpu), 0)
        for r, s in zip(card, cpu):
            tag = f"{r['n_spk']} spk cluster {r['cluster']}"
            put(f"{tag} sub_cos", r["sub_cos"], s["sub_cos"], b["sub_cos"])
            put(f"{tag} within_cos", r["within_cos"], s["within_cos"], b["sub_cos"])
            put(f"{tag} merged", r["merged"], s["merged"], 0)
    elif name == "vad":
        for dom in card:
            for k in ("miss_pct", "fa_pct"):
                put(f"{dom} {k}", card[dom][k], cpu[dom][k], b["vad_pts"])
    elif name == "overlap_det":
        for dom in card:
            for k in ("precision", "recall", "f1"):
                put(f"{dom} {k}", card[dom][k], cpu[dom][k], b["det"])
    elif name == "segmentation":
        for fam in card["frame"]:
            put(f"frame {fam}", card["frame"][fam]["best_perm_acc"],
                cpu["frame"][fam]["best_perm_acc"], b["frame_acc"])
        for eng in card["pipeline"]:
            put(f"{eng} der", card["pipeline"][eng]["der_pct"],
                cpu["pipeline"][eng]["der_pct"], b["der_pts"])
    elif name == "probe":
        for k in ("within_mean", "within_p10", "across_mean", "across_p90",
                  "separation"):
            put(k, card[k], cpu[k], b["cos"])
        for k in ("eer", "purity_at_true_k"):
            put(k, card[k], cpu[k], b["eer"])
    elif name == "enhancer":
        for fam in card:
            put(f"{fam} noisy", card[fam][0], cpu[fam][0], b["si_snr_db"])
            put(f"{fam} enhanced", card[fam][1], cpu[fam][1], b["si_snr_db"])
    elif name == "grid_backends":
        for be in card:
            put(f"{be} der", card[be]["der_pct"], cpu[be]["der_pct"], b["der_pts"])
            put(f"{be} speakers", sum(card[be]["spk"]), sum(cpu[be]["spk"]), 0)
    return d


def main() -> int:
    import torch

    # ---------------------------------------------------------- phase 1 ----
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import speech_diarization_tpu_torch as port

    if Path(port.__file__).resolve().parents[1] != HERE:
        raise RuntimeError(f"imported the port from {port.__file__}, not from "
                           f"this checkout {HERE}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    dev = torch.device("cuda")

    from speech_diarization_tpu_torch.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig, EnhanceConfig,
        OverlapConfig, ResegConfig,
    )
    from speech_diarization_tpu_torch.dsp.mel import (
        _log_mel_1d, log_mel_spectrogram,
    )
    from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
    from speech_diarization_tpu_torch.models.ecapa import (
        _asp_grid_stats_plain, asp_grid_stats,
    )
    from speech_diarization_tpu_torch.models.layers import sliding_mean_time
    from speech_diarization_tpu_torch.models.port import (
        load_segmentation, load_speaker_encoder, load_vad,
    )
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.dsp.framing import num_frames
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.dsp.framing import frame_signal
    from speech_diarization_tpu_torch.dsp.resample import resample_host
    from speech_diarization_tpu_torch.models.port import load_demixer, load_zipenhancer
    from speech_diarization_tpu_torch.pipelines.demix import EnsembleDemixer
    from speech_diarization_tpu_torch.pipelines.enhance import make_enhance_fn
    from speech_diarization_tpu_torch.train.heldout import (
        make_conversation_heldout,
    )
    from speech_diarization_tpu_torch.train.synthetic import make_conversation
    from speech_diarization_tpu_torch.types import SegmentArray

    # the native audio runtime (the resampler of read_audio), built with g++
    from speech_diarization_tpu_torch import native

    if not native.available():
        raise AssertionError(f"native audio runtime: {native.build_error()}")
    sig = np.random.default_rng(0).standard_normal(600 * 44100).astype(np.float32)
    t0 = time.perf_counter()
    native.resample_poly(sig, 44100, SR)
    log(f"[1] native audio runtime {native._lib_path().name} loaded, "
        f"{native.num_threads()} threads; 600 s 44.1 -> 16 kHz in "
        f"{time.perf_counter() - t0:.3f} s")

    # ---------------------------------------------------------- phase 2 ----
    t0 = time.perf_counter()
    reports = kernels.build()
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(sorted(kernels.KERNELS))})")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    # ---------------------------------------------------------- phase 3 ----
    wdir = HERE / "weights"
    enc = load_speaker_encoder(wdir / "ecapa_robust_stream.npz",
                               dtype=torch.bfloat16).to(dev).eval()
    vad = load_vad(wdir / "vad_conv_mc.npz").to(dev).eval()
    # one main-path chunk: 4 s left margin + 60 s core + 5.9 s right margin
    u, m_l, m_r = 60 * SR, 64000, 94400
    wave, _ = make_conversation(np.random.default_rng(1), 70.0, n_speakers=3, sr=SR)
    y = torch.from_numpy(np.clip(wave[:m_l + u + m_r], -0.99, 0.99)
                         .astype(np.float32)).to(dev)
    rows = []
    with torch.inference_mode():
        # K2: fused log-mel on [1,118,400] float32 -> [6991, 40], and on the
        # overlap detector's batch: 24 windows of 80,000 samples every
        # 40,000 from the chunk's core on, read in place (a view)
        wins = y[m_l:m_l + 23 * 40000 + 80000].unfold(0, 80000, 40000)
        k2 = k2_measure(y, y.numel())
        k2b = k2_measure(wins, 23 * 40000 + 80000)
        rows.append({
            "name": "fused_log_mel", "route": "cuda",
            "source": "speech_diarization_tpu_torch/csrc/fused_fbank.cu",
            "replaces": "speech_diarization_tpu/ops/pallas/fused_fbank.py:146",
            **k2, "batch": k2b,
        })
        ref = _log_mel_1d(y, n_mels=40)
        # K1: grid ASP stats on the real trunk features of this chunk
        feats = ref[None]
        feats = feats - sliding_mean_time(feats.transpose(1, 2), 201).transpose(1, 2)
        x = enc.net.trunk(feats, se_win=201)[0]                  # [768, 6991] bf16
        rows.append({
            "name": "asp_grid_stats", "route": "cuda",
            "source": "speech_diarization_tpu_torch/csrc/asp_grid.cu",
            "replaces": "speech_diarization_tpu/ops/pallas/asp_grid.py:168",
            **k1_measure(enc.net, x, u // 1600, m_l // 160),
        })
        # K2 on the whole-file path's VAD batch of the 600 s noisy file: its
        # 43 chunks of 240,000 samples at a 224,000 hop, a view of the
        # padded waveform
        noisy600, _ = make_conversation_heldout(
            np.random.default_rng(0), 600.0, n_speakers=3, sr=SR, snr_db=10.0,
            noise_kind="white")
        n_v = -(-(600 * SR - 240000) // 224000) + 1
        y600 = torch.from_numpy(np.pad(np.clip(noisy600, -0.99, 0.99),
                                       (0, (n_v - 1) * 224000 + 240000 - 600 * SR))
                                .astype(np.float32)).to(dev)
        k2v = k2_measure(y600.unfold(0, 240000, 224000), y600.numel())
        rows[0]["batch_vad"] = k2v
        # K1 at the whole-file grid's short-file chunks: 64 and 256 windows
        # on the trunk features of their spans
        for n_w in (64, 256):
            span = 2 * m_l + (n_w - 1) * 1600 + 32000
            f = _log_mel_1d(y[:span], n_mels=40)[None]
            f = f - sliding_mean_time(f.transpose(1, 2), 201).transpose(1, 2)
            xs = enc.net.trunk(f, se_win=201)[0]
            a = enc.net.k1_inputs(xs, m_l // 160, 10, 201, n_w)
            o, r_ = asp_grid_stats(*a), _asp_grid_stats_plain(*a)
            torch.cuda.synchronize()
            e, tol = (o - r_).abs().max().item(), TOL_REL["asp_grid_stats"] * r_.abs().max().item()
            log(f"[3] asp_grid_stats at W={n_w} (span {span} samples, T_f "
                f"{xs.shape[1]}): max_abs_err {e:.3e} (tol {tol:.3e})")
            if not e <= tol:
                raise AssertionError(f"asp_grid_stats disagrees at W={n_w}")
        # K1 at the other shipped attention widths, on the trunk features of
        # this chunk: ecapa_proto_small.npz (A 32, padded to 64, CC 384, 40
        # mels) and ecapa_synthetic_full_stream.npz (A 128, CC 1536, 80
        # mels), as bench.py loads an encoder (bf16 trunk)
        encs = {tag: load_speaker_encoder(wdir / name, dtype=torch.bfloat16)
                .to(dev).eval() for tag, name in ENCODERS.items()}
        for tag in ("proto_small", "full_stream"):
            net = encs[tag].net
            f = _log_mel_1d(y, n_mels=net.n_mels)[None]
            f = f - sliding_mean_time(f.transpose(1, 2), 201).transpose(1, 2)
            rows[1][f"a{net.att_channels}"] = k1_measure(
                net, net.trunk(f, se_win=201)[0], u // 1600, m_l // 160)
        # K2 at 80 mels on the chunk (the full-width streaming encoder's
        # log-mel), and on the windowed grid's batch: 512 windows of 32,000
        # samples every 1,600 (one encode batch), read in place, at 40 mels
        # (ecapa_synthetic.npz) and 80
        rows[0]["t_80"] = k2_measure(y, y.numel(), n_mels=80)
        yw = y[:511 * 1600 + 32000].unfold(0, 32000, 1600)
        for n_mels in (40, 80):
            rows[0][f"batch_windowed_{n_mels}"] = k2_measure(
                yw, 511 * 1600 + 32000, n_mels=n_mels)
        # K2 on the segmentation engine's and the bucketed mode's rows: (a)
        # every 5 s chunk every 0.625 s of a file, read in place: [89,
        # 80000] (60 s) and [953, 80000] (600 s) at a row stride of 10,000;
        # (b) the engine's 1 s / 0.1 s window grid, [512, 16000] at a row
        # stride of 1,600; (c) the bucketed snippets, [32, 8000 * 2^k]
        # contiguous rows, k = 0..5
        rows[0]["engine_chunks_60s"] = k2_measure(
            y[:88 * 10000 + 80000].unfold(0, 80000, 10000), 88 * 10000 + 80000)
        rows[0]["engine_chunks_600s"] = k2_measure(
            y600[:952 * 10000 + 80000].unfold(0, 80000, 10000), 952 * 10000 + 80000)
        rows[0]["engine_grid"] = k2_measure(
            y[:511 * 1600 + 16000].unfold(0, 16000, 1600), 511 * 1600 + 16000)
        rows[0]["bucketed"] = {8000 << k: k2_measure(
            y600[:32 * (8000 << k)].reshape(32, 8000 << k), 32 * (8000 << k))
            for k in range(6)}
    k1_rows = [{"name": "asp_grid_stats", "shape": f"A {rows[1][k]['a_dim']}",
                **rows[1][k]} for k in ("a32", "a128")]
    k2_rows = [{"name": "fused_log_mel", **rows[0][k]}
               for k in ("t_80", "batch_windowed_40", "batch_windowed_80",
                         "engine_chunks_60s", "engine_chunks_600s", "engine_grid")]
    k2_rows += [{"name": "fused_log_mel", **m} for m in rows[0]["bucketed"].values()]
    for r in rows + [{"name": "fused_log_mel", **k2b},
                     {"name": "fused_log_mel", **k2v}] + k1_rows + k2_rows:
        log(f"[3] {r['name']} {r.get('shape', '')}: max_abs_err "
            f"{r['max_abs_err']:.3e} (tol "
            f"{r['tol']:.3e}), max_rel_err {r['max_abs_err'] / r['ref_max']:.3e} "
            f"(tol {TOL_REL[r['name']]:.0e}); kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), library {r['library_ms']} ms")
        if not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"{r['name']} disagrees with its plain version")
    t0 = time.perf_counter()
    with torch.inference_mode():
        ragged_sweep(enc, dev)
    log(f"    sweep took {time.perf_counter() - t0:.2f} s")
    # the overlap detector at full width on the 24 windows: the card against
    # the CPU, and on the card the kernel's features against the plain ones
    seg_w = wdir / "segmentation_conv.npz"
    seg = load_segmentation(seg_w).to(dev).eval()
    seg_cpu = load_segmentation(seg_w).eval()
    # windows of a conversation that has overlapped speech (the bench's
    # generator has none), cut as the per-chunk program cuts them
    wave_h, _ = make_conversation_heldout(np.random.default_rng(4000), 63.0,
                                          n_speakers=3, sr=SR, overlap_frac=0.3)
    wins = (torch.from_numpy(wave_h[:23 * 40000 + 80000]).to(dev)
            .unfold(0, 80000, 40000))
    with torch.inference_mode():
        hard = seg.hard_activities(wins)
        hard_plain = seg.net.apply_hard(
            (log_mel_spectrogram(wins, n_mels=40) + 6.0) * 0.25)
        hard_cpu = seg_cpu.hard_activities(wins.cpu())
        det_ms = cuda_time_ms(lambda: seg.hard_activities(wins), 10)
    agree = {"card vs CPU": agreement(hard, hard_cpu),
             "kernel vs plain features": agreement(hard, hard_plain)}
    log(f"[3] overlap detector {tuple(wins.shape)} -> {tuple(hard.shape)}: equal "
        f"hard decisions " + ", ".join(f"{k} {100 * v:.4f} %"
                                        for k, v in agree.items())
        + f" (bar {100 * HARD_AGREE:.1f} %); frames with two or more active "
        f"{100 * float((hard.sum(-1) >= 2).float().mean()):.2f} %; "
        f"{det_ms:.3f} ms a chunk on the card")
    if min(agree.values()) < HARD_AGREE:
        raise AssertionError("the overlap detector's hard decisions disagree")
    # GTCRN (gtcrn_mc.npz) on 10 s of a noisy file: the card against the CPU
    noisy10, _ = make_conversation_heldout(np.random.default_rng(5), 10.0,
                                           n_speakers=2, sr=SR, snr_db=10.0,
                                           noise_kind="white")
    g_card = make_enhance_fn("gtcrn", device=dev)
    y10 = torch.from_numpy(noisy10.astype(np.float32))
    out_c = g_card(y10.to(dev)).cpu()
    out_p = make_enhance_fn("gtcrn", device="cpu")(y10)
    g_err = float((out_c - out_p).abs().max() / out_p.abs().max())
    g_ms = cuda_time_ms(lambda: g_card(y10.to(dev)), 5)
    log(f"[3] GTCRN on 10 s, card vs CPU: max rel err {g_err:.3e} (bar "
        f"{GTCRN_TOL_REL:.0e}); {g_ms:.3f} ms on the card")
    if not g_err <= GTCRN_TOL_REL:
        raise AssertionError("GTCRN on the card disagrees with the CPU")
    # ZipEnhancer (zipenhancer_mc.npz): four 2 s windows, card against CPU;
    # then one batch of 64 windows of the 600 s file (the pipeline's batch)
    zip_card = load_zipenhancer(wdir / "zipenhancer_mc.npz").to(dev)
    x4 = y10[:4 * 32000].reshape(4, 32000)
    with torch.inference_mode():
        z_c = zip_card(x4.to(dev)).cpu()
        z_p = load_zipenhancer(wdir / "zipenhancer_mc.npz")(x4)
        z_err = float((z_c - z_p).abs().max() / z_p.abs().max())
        x64 = y600[:63 * 24000 + 32000].unfold(0, 32000, 24000)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        z64_ms = cuda_time_ms(lambda: zip_card(x64), 5)
        z64_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    z64_flops = zipenhancer_flops(64)
    log(f"[3] ZipEnhancer on four 2 s windows, card vs CPU: max rel err "
        f"{z_err:.3e} (bar {ZIP_TOL_REL:.0e}); one batch of 64 windows: "
        f"{z64_ms:.2f} ms on the card, {z64_peak:.2f} GB above the resident "
        f"set, {sum(z64_flops.values()) / z64_ms / 1e9:.2f} TFLOP/s achieved on "
        f"{sum(z64_flops.values()):.3e} FLOPs ({', '.join(f'{k} {v:.2e}' for k, v in z64_flops.items())})")
    if not z_err <= ZIP_TOL_REL:
        raise AssertionError("ZipEnhancer on the card disagrees with the CPU")
    # the demixer on one 10 s stereo chunk at 44.1 kHz, card against CPU, at
    # the shipped geometry and the constructor's; then each on the 80 chunks
    # of the 600 s file, with the host resampling of that file both ways
    t0 = time.perf_counter()
    up600 = resample_host(noisy600.astype(np.float32), SR, 44100)
    up_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resample_host(up600, 44100, SR)
    down_s = time.perf_counter() - t0
    x80 = frame_signal(torch.from_numpy(np.stack([up600, up600])).to(dev),
                       441000, 330750).transpose(0, 1)
    demix_ms = {}
    for label, cpu_net in (("24/4/1 demix_synthetic.npz",
                            load_demixer(wdir / "demix_synthetic.npz")),
                           ("48/5/2 seeded", seeded_demixer(0))):
        card_net = copy.deepcopy(cpu_net).to(dev)
        with torch.inference_mode():
            d_c = card_net(x80[3:4]).cpu()
            d_p = cpu_net(x80[3:4].cpu())
            d_err = float((d_c - d_p).abs().max() / d_p.abs().max())
            ens = EnsembleDemixer([card_net], device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            demix_ms[label] = cuda_time_ms(lambda: ens._forward(x80), 3)
            d_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        log(f"[3] demixer {label} on one 10 s chunk, card vs CPU: max rel err "
            f"{d_err:.3e} (bar {DEMIX_TOL_REL:.0e}); {x80.shape[0]} chunks of "
            f"[2, 441000] (600 s): {demix_ms[label]:.2f} ms on the card, "
            f"{d_peak:.2f} GB above the resident set")
        if not d_err <= DEMIX_TOL_REL:
            raise AssertionError(f"the demixer {label} on the card disagrees "
                                 "with the CPU")
    log(f"[3] host resampling of the 600 s file: 16 -> 44.1 kHz {up_s:.3f} s, "
        f"44.1 -> 16 kHz {down_s:.3f} s")
    del x80, up600
    # K3, the demix-dialog front-end's resampling on the card
    rows.append(resample_phase(dev))

    # ---------------------------------------------------------- phase 4 ----
    def bench_cfg(overlap: bool, **kw):
        return DiarizationConfig(
            cluster=ClusterConfig(method="spectral", max_speakers=8),
            embed=EmbedConfig(grid_backend="auto"),
            overlap=OverlapConfig(enabled=overlap), **kw)

    def der_pct(truth, segs) -> float:
        return 100.0 * diarization_error_rate(SegmentArray(*truth), segs).der

    launches, forms, walls_by = {}, {}, {}
    for overlap in (False, True):
        pipe = DiarizationPipeline(bench_cfg(overlap), encoder=enc, vad=vad)
        for dur in (60, 600):
            wave, truth = make_conversation(np.random.default_rng(0), float(dur),
                                            n_speakers=3, sr=SR)
            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = pipe((wave, SR))
            warm = time.perf_counter() - t0
            launches[overlap, dur] = dict(kernels.LAUNCHES)
            forms[overlap, dur] = dict(kernels.LAUNCH_FORMS)
            walls = []
            for _ in range(4):
                t0 = time.perf_counter()
                pipe((wave, SR))
                walls.append(time.perf_counter() - t0)
            walls_by[overlap, dur] = min(walls)
            der = der_pct(truth, res.segments)
            bar = JAX_CPU_DER_PCT[overlap][dur] + DER_SLACK_PCT
            log(f"[4] overlap {'on' if overlap else 'off'}, {dur} s: warm "
                f"{warm:.3f} s, timed {min(walls):.4f} s "
                f"(walls {[round(w, 4) for w in walls]}) -> RTF "
                f"{dur / min(walls):.1f}x; {len(res.segments)} segments, "
                f"{res.num_speakers} speakers, DER {der:.4f} % (bar {bar:.4f} %); "
                f"launches {launches[overlap, dur]} {forms[overlap, dur]}")
            probs = res.diagnostics["vad_probs"]
            grid = res.diagnostics["window_embeddings"]
            if not (np.isfinite(probs).all() and np.isfinite(grid).all()):
                raise AssertionError("non-finite VAD probabilities or embeddings")
            if probs.shape != (dur * 100 + 1,) or grid.shape[1] != 128:
                raise AssertionError(f"bad shapes {probs.shape} {grid.shape}")
            n_chunks = dur // 60
            want = {"asp_grid_stats": n_chunks,
                    "fused_log_mel": (2 if overlap else 1) * n_chunks,
                    "resample_poly": 0}
            want_forms = {"fused_log_mel[T]": n_chunks}
            if overlap:
                want_forms["fused_log_mel[B, T]"] = n_chunks
                hard = res.diagnostics["overlap_hard"]
                # a whole-file detector scores ceil((T - 5 s) / 2.5 s) + 1 windows
                if hard.shape != (-(-(dur - 5) * 2 // 5) + 1, 501, 3) or not (
                        np.isin(hard, (0.0, 1.0)).all()):
                    raise AssertionError(f"bad hard decisions {hard.shape}")
            if launches[overlap, dur] != want or forms[overlap, dur] != want_forms:
                raise AssertionError(
                    f"launch counts {launches[overlap, dur]} "
                    f"{forms[overlap, dur]}, expected {want} {want_forms}")
            if not der <= bar:
                raise AssertionError(f"DER {der:.4f} % above the bar {bar:.4f} %")
    log(f"[4] the detector's cost, min walls on against off: 60 s "
        f"{walls_by[True, 60] - walls_by[False, 60]:+.4f} s, 600 s "
        f"{walls_by[True, 600] - walls_by[False, 600]:+.4f} s")

    # --------------------------------------------------------- phase 4b ----
    wave, truth = make_conversation_heldout(np.random.default_rng(4000), 60.0,
                                            n_speakers=3, sr=SR, overlap_frac=0.3)
    held = {}
    for overlap in (False, True):
        pipe = DiarizationPipeline(
            bench_cfg(overlap, reseg=ResegConfig(enabled=True)),
            encoder=enc, vad=vad)
        kernels.reset_launches()
        res = pipe((wave, SR))
        held[overlap] = (res, der_pct(truth, res.segments), dict(kernels.LAUNCHES))
    res, der_on, n_launch = held[True]
    n_added = len(res.segments) - len(held[False][0].segments)
    regions = res.diagnostics.get("overlap_regions")
    log(f"[4b] held-out 60 s file with overlapped speech, reassignment on: "
        f"detector {'armed' if regions is not None else 'NOT armed'}, "
        f"{0 if regions is None else len(regions)} overlap regions, {n_added} "
        f"second-speaker segments added, DER {der_on:.4f} % with the rescue, "
        f"{held[False][1]:.4f} % without; launches {n_launch}")
    if regions is None or n_added < 1 or not der_on <= held[False][1]:
        raise AssertionError("the overlap rescue did not arm, added nothing "
                             "or made DER worse")

    # ------------------------------------------------- phases 4c and 4d ----
    def timed_pipe(backend: str):
        """The config's defaults with the enhancement ``backend``, its
        enhancer wrapped in CUDA events (one span a call)."""
        pipe = DiarizationPipeline(
            bench_cfg(True, enhance=EnhanceConfig(backend=backend)),
            encoder=enc, vad=vad)
        inner, spans = pipe.enhance_fn, []

        def timed_enhance(y):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = inner(y)
            e1.record()
            spans.append((e0, e1))
            return out

        pipe.enhance_fn = timed_enhance
        return pipe, spans

    def noisy_route(phase, pipe, spans, backend, noise, snr, dur, bar, n_timed=3):
        """One held-out draw through the whole-file path: warm and timed
        walls, the enhancer's span, peak memory, DER, launch counts."""
        wave, truth = make_conversation_heldout(
            np.random.default_rng(0), float(dur), n_speakers=3, sr=SR,
            snr_db=snr, noise_kind=noise)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe((wave, SR))
        warm = time.perf_counter() - t0
        n_launch, n_forms = dict(kernels.LAUNCHES), dict(kernels.LAUNCH_FORMS)
        n_shapes = dict(kernels.LAUNCH_SHAPES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        walls, e_ms = [], []
        for _ in range(n_timed):
            spans.clear()
            t0 = time.perf_counter()
            pipe((wave, SR))
            walls.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            e_ms.append(sum(a.elapsed_time(b) for a, b in spans))
        d = res.diagnostics
        der = der_pct(truth, res.segments)
        t = len(wave)
        n_v = 1 if t <= 240000 else -(-(t - 240000) // 224000) + 1
        n_w = num_frames(t, 32000, 1600)
        n_g = -(-n_w // min(600, 1 << max(6, (n_w - 1).bit_length())))
        # K3 twice a demixed file: 16 -> 44.1 kHz and the stem back
        n_k3 = 2 if backend == "demix-dialog" else 0
        want = {"asp_grid_stats": n_g, "fused_log_mel": -(-n_v // 64) + n_g,
                "resample_poly": n_k3}
        want_forms = {"fused_log_mel[B, T]": -(-n_v // 64), "fused_log_mel[T]": n_g}
        if n_k3:
            want_forms["resample_poly[T]"] = n_k3
        log(f"[{phase}] {backend}, {noise}{snr:g}, {dur} s: route {d.get('route')}, "
            f"enhancer {d.get('enhancer')}, est SNR "
            f"{d.get('snr_db', float('nan')):.2f} dB, floor HF "
            f"{d.get('floor_hf_frac', float('nan')):.3f}; warm {warm:.3f} s, "
            f"timed {min(walls):.4f} s (walls {[round(w, 4) for w in walls]}) "
            f"-> RTF {dur / min(walls):.1f}x; enhancer {min(e_ms):.2f} ms on "
            f"the card's clock ({[round(g, 2) for g in e_ms]}); peak device "
            f"memory {peak_gb:.2f} GB; {len(res.segments)} segments, "
            f"{res.num_speakers} speakers, DER {der:.4f} % (bar "
            f"{'none' if bar is None else f'{bar:.4f} %'}); launches {n_launch} "
            f"{n_forms}")
        if d.get("route") != "legacy" or d.get("enhancer") != backend:
            raise AssertionError(f"the noisy file did not take the {backend} route")
        probs = d["vad_probs"]
        grid = d.get("window_embeddings")
        if probs.shape != (dur * 100 + 1,) or not (
                np.isfinite(probs).all()
                and (grid is None or np.isfinite(grid).all())):
            raise AssertionError(f"bad VAD probabilities or grid {probs.shape}")
        if grid is None and len(res.segments):
            raise AssertionError("segments without a grid")
        if n_launch != want or n_forms != want_forms:
            raise AssertionError(f"launch counts {n_launch} {n_forms}, expected "
                                 f"{want} {want_forms}")
        if bar is not None and not der <= bar:
            raise AssertionError(f"DER {der:.4f} % above the bar {bar:.4f} %")
        return {"launches": n_launch, "forms": n_forms, "shapes": n_shapes,
                "ms": min(e_ms), "peak_gb": peak_gb, "der": der, "wall": min(walls)}

    pipe, spans = timed_pipe("gtcrn")
    noisy = {key: noisy_route("4c", pipe, spans, "gtcrn", *key,
                              JAX_CPU_DER_PCT_NOISY[key] + DER_SLACK_PCT)
             for key in JAX_CPU_DER_PCT_NOISY}
    enhanced = {}
    for backend in ("zipenhancer", "demix-dialog"):
        pipe, spans = timed_pipe(backend)
        for key, jax_der in JAX_CPU_DER_PCT_ENHANCED.items():
            if key[0] == backend:
                enhanced[key] = noisy_route(
                    "4d", pipe, spans, *key,
                    None if jax_der is None else jax_der + DER_SLACK_PCT,
                    n_timed=2 if key[3] == 600 else 3)
    z600 = enhanced["zipenhancer", "white", 10.0, 600]
    z_flops = sum(zipenhancer_flops(num_frames(600 * SR, 32000, 24000)).values())
    log(f"[4d] ZipEnhancer on the 600 s white10 file: {z600['ms']:.2f} ms, "
        f"{z_flops:.3e} FLOPs -> {z_flops / z600['ms'] / 1e9:.2f} TFLOP/s; DER "
        f"{z600['der']:.4f} % beside the GTCRN route's "
        f"{noisy['white', 10.0, 600]['der']:.4f} % (no JAX bar at 600 s)")

    # -------------------------------------------------------- phase 4e ----
    # the other encoders, VADs and clustering methods on the 60 s bench draw
    # (overlap on): streamed with K1 at A 128 / K2 at 80 mels and with K1 at
    # A 32; the full-width encoder on the windowed grid (K2's windowed batch
    # at 80 mels); the windowed grid with the GRU VAD and the energy VAD;
    # AHC and HDBSCAN on the default encoder.  Each is held within one DER
    # point of its JAX CPU bar, either way.  Besides the counts by kernel
    # and by form, the counts by shape of the rows that the kernels line
    # reads: K1 by padded attention width, K2 by row length and mel count
    wave, truth = make_conversation(np.random.default_rng(0), 60.0,
                                    n_speakers=3, sr=SR)
    gru = load_vad(wdir / "vad_synthetic.npz")
    k1_a128 = "asp_grid_stats A 128, CC 1536, win_f 201, hop_f 10"
    k1_a64_384 = "asp_grid_stats A 64, CC 384, win_f 201, hop_f 10"
    k2_t80, k2_t40 = "fused_log_mel [T] 80 mels", "fused_log_mel [T] 40 mels"
    k2_w40 = "fused_log_mel [B, T] rows of 32000 at a stride of 1600, 40 mels"
    k2_w80 = "fused_log_mel [B, T] rows of 32000 at a stride of 1600, 80 mels"
    options = {
        # tag: (encoder, VAD, method, grid backend, route, grid, launches,
        #       launch forms, launches of the shapes read below)
        "full_stream": (encs["full_stream"], vad, "spectral", "auto", "streamed",
                        None, {"asp_grid_stats": 1, "fused_log_mel": 3, "resample_poly": 0},
                        {"fused_log_mel[T]": 2, "fused_log_mel[B, T]": 1},
                        {k1_a128: 1, k2_t80: 1, k2_t40: 1}),
        # the windowed grid: one batch launch for the VAD's 15 s chunks
        # (conv and GRU; the energy VAD has no log-mel), two for 581
        # windows in batches of 512, one for the standalone overlap
        # detector's 23 windows
        "full_stream_windowed": (encs["full_stream"], vad, "spectral",
                                 "windowed", "legacy", "windowed",
                                 {"asp_grid_stats": 0, "fused_log_mel": 4, "resample_poly": 0},
                                 {"fused_log_mel[B, T]": 4}, {k2_w80: 2}),
        "proto_small": (encs["proto_small"], vad, "spectral", "auto", "streamed",
                        None, {"asp_grid_stats": 1, "fused_log_mel": 2, "resample_poly": 0},
                        {"fused_log_mel[T]": 1, "fused_log_mel[B, T]": 1},
                        {k1_a64_384: 1, k2_t40: 1}),
        "windowed_gru": (encs["windowed"], gru, "spectral", "auto", "legacy",
                         "windowed", {"asp_grid_stats": 0, "fused_log_mel": 4, "resample_poly": 0},
                         {"fused_log_mel[B, T]": 4}, {k2_w40: 2}),
        "windowed_energy": (encs["windowed"], None, "spectral", "auto", "legacy",
                            "windowed", {"asp_grid_stats": 0, "fused_log_mel": 3, "resample_poly": 0},
                            {"fused_log_mel[B, T]": 3}, {k2_w40: 2}),
        "ahc": (enc, vad, "ahc", "auto", "streamed", None,
                {"asp_grid_stats": 1, "fused_log_mel": 2, "resample_poly": 0},
                {"fused_log_mel[T]": 1, "fused_log_mel[B, T]": 1}, {}),
        "hdbscan": (enc, vad, "hdbscan", "auto", "streamed", None,
                    {"asp_grid_stats": 1, "fused_log_mel": 2, "resample_poly": 0},
                    {"fused_log_mel[T]": 1, "fused_log_mel[B, T]": 1}, {}),
    }
    opt_launches, opt_shapes = {}, {}
    for tag, (encoder, v, method, backend, route, grid_kind, want, want_forms,
              want_shapes) in options.items():
        pipe = DiarizationPipeline(
            DiarizationConfig(cluster=ClusterConfig(method=method, max_speakers=8),
                              embed=EmbedConfig(grid_backend=backend),
                              overlap=OverlapConfig(enabled=True)),
            encoder=encoder, vad=v)
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe((wave, SR))
        warm = time.perf_counter() - t0
        n_launch, n_forms = dict(kernels.LAUNCHES), dict(kernels.LAUNCH_FORMS)
        opt_launches[tag] = n_launch
        opt_shapes[tag] = n_shapes = dict(kernels.LAUNCH_SHAPES)
        t0 = time.perf_counter()
        pipe((wave, SR))
        wall = time.perf_counter() - t0
        d = res.diagnostics
        der = der_pct(truth, res.segments)
        jax_der = JAX_CPU_DER_PCT_OPTIONS[tag]
        log(f"[4e] {tag} ({type(encoder.net).__name__} A "
            f"{encoder.net.att_channels}, {encoder.net.n_mels} mels; VAD "
            f"{type(getattr(pipe.vad, 'net', pipe.vad)).__name__}; {method}): route "
            f"{d.get('route')}, grid {d.get('grid', 'streaming')}; warm "
            f"{warm:.3f} s, timed {wall:.4f} s; {len(res.segments)} segments, "
            f"{res.num_speakers} speakers, DER {der:.4f} % (JAX CPU {jax_der:.4f} "
            f"% +- {DER_SLACK_PCT}); launches {n_launch} {n_forms} {n_shapes}")
        if d.get("route") != route or (grid_kind and d.get("grid") != grid_kind):
            raise AssertionError(f"{tag}: took route {d.get('route')} / grid "
                                 f"{d.get('grid')}")
        probs, grid = d["vad_probs"], d["window_embeddings"]
        if not (np.isfinite(probs).all() and np.isfinite(grid).all()
                and grid.shape == (581, encoder.net.emb_dim)):
            raise AssertionError(f"{tag}: bad VAD probabilities or grid "
                                 f"{probs.shape} {grid.shape}")
        got_shapes = {k: n_shapes.get(k, 0) for k in want_shapes}
        if n_launch != want or n_forms != want_forms or got_shapes != want_shapes:
            raise AssertionError(f"{tag}: launch counts {n_launch} {n_forms} "
                                 f"{got_shapes}, expected {want} {want_forms} "
                                 f"{want_shapes}")
        if not abs(der - jax_der) <= DER_SLACK_PCT:
            raise AssertionError(f"{tag}: DER {der:.4f} % more than "
                                 f"{DER_SLACK_PCT} point from the JAX CPU "
                                 f"{jax_der:.4f} %")
    # the windowed grid on the 600 s bench draw: launches per 600 s (VAD 0,
    # grid ceil(5981 / 512) = 12, detector ceil(239 / 24) = 10), no JAX bar
    wave600, truth600 = make_conversation(np.random.default_rng(0), 600.0,
                                          n_speakers=3, sr=SR)
    kernels.reset_launches()
    torch.cuda.synchronize()
    pipe_w = DiarizationPipeline(bench_cfg(True), encoder=encs["windowed"])
    t0 = time.perf_counter()
    res = pipe_w((wave600, SR))
    warm = time.perf_counter() - t0
    n_launch, n_shapes = dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES)
    t0 = time.perf_counter()
    pipe_w((wave600, SR))
    wall = time.perf_counter() - t0
    log(f"[4e] windowed_energy, 600 s: warm {warm:.3f} s, timed {wall:.4f} s; "
        f"DER {der_pct(truth600, res.segments):.4f} % (no JAX bar); launches "
        f"{n_launch} {n_shapes}")
    if n_launch != {"asp_grid_stats": 0, "fused_log_mel": 22, "resample_poly": 0} or (
            n_shapes.get(k2_w40) != 12):
        raise AssertionError(f"windowed 600 s: launch counts {n_launch} {n_shapes}")
    opt_launches["windowed_600"], opt_shapes["windowed_600"] = n_launch, n_shapes

    # -------------------------------------------------------- phase 4f ----
    # held-out file 0 (seed 1000) of each domain at the CLI's defaults
    from speech_diarization_tpu_torch.cli import (
        _add_common_config_args, build_config, build_pipeline_kwargs,
    )
    from speech_diarization_tpu_torch.train.heldout import make_domain_file

    import argparse

    ap = argparse.ArgumentParser()
    _add_common_config_args(ap)
    cli_args = ap.parse_args([])
    pipe = DiarizationPipeline(build_config(cli_args),
                               **build_pipeline_kwargs(cli_args))
    held_der = {}
    for domain, jax_der in JAX_CPU_DER_PCT_HELDOUT_CLI.items():
        wave, truth = make_domain_file(domain, 0)
        res = pipe((wave, SR))
        held_der[domain] = der = 100.0 * diarization_error_rate(
            SegmentArray(*truth), res.segments, collar_s=0.25).der
        log(f"[4f] {domain}: route {res.diagnostics.get('route')}, "
            f"{res.num_speakers} speakers, DER {der:.4f} % (collar 0.25 s; "
            f"JAX CPU {jax_der:.4f} % +- {DER_SLACK_PCT})")
        if not abs(der - jax_der) <= DER_SLACK_PCT:
            raise AssertionError(f"held-out {domain}: DER {der:.4f} % more than "
                                 f"{DER_SLACK_PCT} point from the JAX CPU bar")

    # -------------------------------------------------------- phase 4g ----
    # the corpus worker on three 60 s draws, the second noisy (whole-file
    # path): each file's segments are its lone call's, no errors
    from speech_diarization_tpu_torch.pipelines.corpus import corpus_diarize

    pipe = DiarizationPipeline(bench_cfg(True), encoder=enc, vad=vad)
    draws = [make_conversation(np.random.default_rng(40), 60.0, n_speakers=3,
                               sr=SR)[0],
             make_conversation_heldout(np.random.default_rng(41), 60.0,
                                       n_speakers=3, sr=SR, snr_db=10.0,
                                       noise_kind="white")[0],
             make_conversation(np.random.default_rng(42), 60.0, n_speakers=3,
                               sr=SR)[0]]
    lone = [pipe((w, SR)) for w in draws]
    report = corpus_diarize([(w, SR) for w in draws],
                            pipeline_factory=lambda: pipe, keep_results=True)
    log(f"[4g] corpus of three 60 s files: {report.summary()}, routes "
        f"{[r.diagnostics.get('route') for r in lone]}, per-file walls "
        f"{[f['wall_s'] for f in sorted(report.files, key=lambda f: f['index'])]}")
    if report.errors or len(report.files) != 3:
        raise AssertionError(f"corpus errors {report.errors}")
    for f in report.files:
        a, b = f["result"].segments, lone[f["index"]].segments
        if not (len(a) == len(b) and np.array_equal(a.starts, b.starts)
                and np.array_equal(a.ends, b.ends) and np.array_equal(a.spks, b.spks)):
            raise AssertionError(f"corpus file {f['index']}: segments differ "
                                 "from its lone call's")
    if [r.diagnostics.get("route") for r in lone] != ["streamed", "legacy", "streamed"]:
        raise AssertionError("the corpus draws did not take both routes")

    # -------------------------------------------------------- phase 4h ----
    # the segmentation engine at its defaults (segmentation_conv.npz, the
    # bf16 encoder, spectral clustering) on the 60 s and 600 s bench draws
    # and held-out overlap file 0, and segmentation_ow3.npz (cuDNN BiGRUs) on
    # the 60 s draw: walls, peak memory, K2 launches by shape, DER within one
    # point of the JAX CPU bar either way; then the engine's hard decisions
    # on the card against the CPU on the 60 s draw's chunks
    from speech_diarization_tpu_torch.pipelines.segmentation import (
        make_seg_activities_fn, segmentation_diarize,
    )

    seg_fns = {n: make_seg_activities_fn(load_segmentation(
        wdir / f"segmentation_{n}.npz").to(dev).eval()) for n in ("conv", "ow3")}
    eng_draws = {f"bench_{d}s": make_conversation(np.random.default_rng(0), float(d),
                                                  n_speakers=3, sr=SR)
                 for d in (60, 600)}
    eng_draws["heldout_overlap_0"] = make_domain_file("heldout-overlap", 0)
    k2_chunks = "fused_log_mel [B, T] rows of 80000 at a stride of 10000, 40 mels"
    k2_grid1 = "fused_log_mel [B, T] rows of 16000 at a stride of 1600, 40 mels"
    engine = {}
    for net, tag in [("conv", t) for t in eng_draws] + [("ow3", "bench_60s")]:
        wave, truth = eng_draws[tag]
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        segs = segmentation_diarize(wave, SR, seg_fns[net], enc.encode_batch)
        warm = time.perf_counter() - t0
        n_launch, n_shapes = dict(kernels.LAUNCHES), dict(kernels.LAUNCH_SHAPES)
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        walls = []
        for _ in range(2 if tag == "bench_600s" else 3):
            t0 = time.perf_counter()
            segmentation_diarize(wave, SR, seg_fns[net], enc.encode_batch)
            walls.append(time.perf_counter() - t0)
        der = der_pct(truth, segs)
        jax_der = JAX_CPU_DER_PCT_ENGINE[f"{net}_{tag}"]
        dur = len(wave) / SR
        n_w = num_frames(len(wave), 16000, 1600, pad_tail=True)
        want = {"asp_grid_stats": 0, "fused_log_mel": 1 + -(-n_w // 512),
                "resample_poly": 0}
        want_shapes = {k2_chunks: 1, k2_grid1: -(-n_w // 512)}
        engine[net, tag] = {"wall": min(walls), "der": der, "peak_gb": peak_gb,
                            "launches": n_launch, "shapes": n_shapes}
        log(f"[4h] engine {net}, {tag}: warm {warm:.3f} s, timed {min(walls):.4f} s "
            f"(walls {[round(w, 4) for w in walls]}) -> RTF {dur / min(walls):.1f}x; "
            f"peak device memory {peak_gb:.3f} GB above the resident set; "
            f"{len(segs)} segments, {len({int(k) for k in segs.spks})} speakers, "
            f"DER {der:.4f} % (JAX CPU {jax_der:.4f} % +- {DER_SLACK_PCT}); "
            f"launches {n_launch} {n_shapes}")
        if not (len(segs) and np.isfinite(segs.starts).all()
                and (segs.ends > segs.starts).all()):
            raise AssertionError(f"engine {net} {tag}: bad segments")
        if n_launch != want or {k: n_shapes.get(k, 0) for k in want_shapes} != want_shapes:
            raise AssertionError(f"engine {net} {tag}: launch counts {n_launch} "
                                 f"{n_shapes}, expected {want} {want_shapes}")
        if not abs(der - jax_der) <= DER_SLACK_PCT:
            raise AssertionError(f"engine {net} {tag}: DER {der:.4f} % more than "
                                 f"{DER_SLACK_PCT} point from the JAX CPU {jax_der:.4f} %")
    wave60 = eng_draws["bench_60s"][0]
    chunks = torch.from_numpy(wave60).to(dev)[:88 * 10000 + 80000].unfold(0, 80000, 10000)
    for net in ("conv", "ow3"):
        cpu_fn = make_seg_activities_fn(load_segmentation(
            wdir / f"segmentation_{net}.npz").eval())
        agree_e = agreement(seg_fns[net](chunks)[..., 3:], cpu_fn(chunks.cpu())[..., 3:])
        log(f"[4h] engine {net} on the 60 s draw's {chunks.shape[0]} chunks: equal "
            f"hard decisions card vs CPU {100 * agree_e:.4f} % (bar "
            f"{100 * HARD_AGREE:.1f} %)")
        if agree_e < HARD_AGREE:
            raise AssertionError(f"engine {net}: hard decisions card vs CPU disagree")

    # -------------------------------------------------------- phase 4i ----
    # bucketed segment embeddings (the whole-file path) on the 60 s bench
    # draw: DER within one point of the JAX CPU bar, K2 launches by bucket
    wave, truth = eng_draws["bench_60s"]
    pipe = DiarizationPipeline(DiarizationConfig(
        cluster=ClusterConfig(method="spectral", max_speakers=8),
        embed=EmbedConfig(grid_backend="auto", mode="bucketed"),
        overlap=OverlapConfig(enabled=True)), encoder=enc, vad=vad)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe((wave, SR))
    warm = time.perf_counter() - t0
    b_shapes = dict(kernels.LAUNCH_SHAPES)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe((wave, SR))
        walls.append(time.perf_counter() - t0)
    der = der_pct(truth, res.segments)
    buckets = {int(k.split()[5]): v for k, v in b_shapes.items()
               if k.startswith("fused_log_mel [B, T]")
               and k.split()[5] == k.split()[10].rstrip(",")}
    log(f"[4i] bucketed, 60 s: route {res.diagnostics.get('route')}; warm {warm:.3f} "
        f"s, timed {min(walls):.4f} s (walls {[round(w, 4) for w in walls]}); "
        f"{len(res.segments)} segments, {res.num_speakers} speakers, DER {der:.4f} % "
        f"(JAX CPU {JAX_CPU_DER_PCT_BUCKETED:.4f} % +- {DER_SLACK_PCT}); K2 launches by "
        f"bucket (samples: launches) {buckets}; all launches {b_shapes}")
    if res.diagnostics.get("route") != "legacy" or not buckets or any(
            b not in rows[0]["bucketed"] for b in buckets):
        raise AssertionError(f"bucketed: route {res.diagnostics.get('route')}, "
                             f"bucket launches {buckets}")
    if not abs(der - JAX_CPU_DER_PCT_BUCKETED) <= DER_SLACK_PCT:
        raise AssertionError(f"bucketed: DER {der:.4f} % more than {DER_SLACK_PCT} "
                             f"point from the JAX CPU {JAX_CPU_DER_PCT_BUCKETED:.4f} %")
    bucketed_wall = min(walls)
    # the same on the 600 s bench draw: launches by bucket per 600 s (no
    # JAX bar at 600 s)
    wave600b, truth600b = eng_draws["bench_600s"]
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pipe((wave600b, SR))
    b600_wall = time.perf_counter() - t0
    buckets600 = {int(k.split()[5]): v for k, v in kernels.LAUNCH_SHAPES.items()
                  if k.startswith("fused_log_mel [B, T]")
                  and k.split()[5] == k.split()[10].rstrip(",")}
    log(f"[4i] bucketed, 600 s: warm {b600_wall:.3f} s; {len(res.segments)} "
        f"segments, DER {der_pct(truth600b, res.segments):.4f} % (no JAX bar); K2 "
        f"launches by bucket {buckets600}")
    if not buckets600 or any(b not in rows[0]["bucketed"] for b in buckets600):
        raise AssertionError(f"bucketed 600 s: bucket launches {buckets600}")

    # -------------------------------------------------------- phase 4j ----
    # batch (Diarizer()'s defaults, each engine) on a directory of two 60 s
    # WAVs: RTTMs and stems written, RTTM lines equal the JAX CPU bars' to
    # the frame (scripts/torch_port_batch_bars.json), DER within one point,
    # a second run (and the CLI's batch) skips both files; then diag
    # (save_plots=False) on one of them
    import tempfile

    from speech_diarization_tpu_torch.cli import main as cli_main
    from speech_diarization_tpu_torch.io.audio import write_wav
    from speech_diarization_tpu_torch.pipelines.baseline import run_batch
    from speech_diarization_tpu_torch.pipelines.diagnostic import diagnose

    batch_bars = json.loads((HERE / "scripts" / "torch_port_batch_bars.json").read_text())
    b_draws = [make_conversation(np.random.default_rng(50 + i), 60.0, n_speakers=3,
                                 sr=SR) for i in range(2)]
    batch_walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        for eng in ("flagship", "segmentation"):
            root = Path(tmp) / eng
            for i, (wv, _) in enumerate(b_draws):
                write_wav(root / f"draw{i}.wav", wv, SR)
            t0 = time.perf_counter()
            done = run_batch(root, engine=eng)
            batch_walls[eng] = time.perf_counter() - t0
            stems = sorted(p.relative_to(root) for p in root.rglob("*-speakers/**/*.wav"))
            worst, ders = 0.0, []
            for i, (_, truth) in enumerate(b_draws):
                rttm = (root / f"draw{i}.rttm").read_text()
                got = [[float(f[3]), float(f[4]), f[7]]
                       for f in (ln.split() for ln in rttm.splitlines())]
                bar = batch_bars["engines"][eng]["files"][f"draw{i}"]
                if len(got) != len(bar["rttm"]) or any(
                        g[2] != b[2] for g, b in zip(got, bar["rttm"])):
                    raise AssertionError(f"batch {eng} draw{i}: RTTM {got} differs "
                                         f"from the bar {bar['rttm']}")
                worst = max([worst] + [abs(g[k] - b[k]) for g, b in zip(got, bar["rttm"])
                                       for k in (0, 1)])
                names = sorted({g[2] for g in got})
                ders.append(der_pct(truth, SegmentArray(
                    np.array([g[0] for g in got]), np.array([g[0] + g[1] for g in got]),
                    np.array([names.index(g[2]) for g in got]))))
                if not abs(ders[-1] - bar["der_pct"]) <= DER_SLACK_PCT:
                    raise AssertionError(f"batch {eng} draw{i}: DER {ders[-1]:.4f} %")
            again = run_batch(root, engine=eng)
            before = [(root / f"draw{i}.rttm").read_text() for i in range(2)]
            cli_rc = cli_main(["batch", str(root), "--engine", eng])
            after = [(root / f"draw{i}.rttm").read_text() for i in range(2)]
            log(f"[4j] batch --engine {eng}: {len(done)} files in "
                f"{batch_walls[eng]:.3f} s, {len(stems)} stem WAVs, RTTM edges within "
                f"{worst:.3f} s of the JAX CPU bars, DER {[round(d, 4) for d in ders]} % "
                f"(bars {[batch_bars['engines'][eng]['files'][f'draw{i}']['der_pct'] for i in range(2)]}); "
                f"second run {again}, the CLI's batch rc {cli_rc}, RTTMs unchanged "
                f"{before == after}")
            if len(done) != 2 or not stems or worst > 0.0105 or again or cli_rc != 0 or (
                    before != after):
                raise AssertionError(f"batch {eng}: files {done}, stems {len(stems)}, "
                                     f"edge difference {worst}, rerun {again}")
        t0 = time.perf_counter()
        report = diagnose(Path(tmp) / "flagship" / "draw0.wav", out_dir=Path(tmp) / "diag",
                          save_plots=False, **build_pipeline_kwargs(cli_args))
        diag_wall = time.perf_counter() - t0
        stats = report.similarity_stats()
        log(f"[4j] diag on draw0 (save_plots=False): {diag_wall:.3f} s, "
            f"{len(report.segments)} segments, {len(report.speakers)} speakers, "
            f"similarity {({k: round(v, 4) for k, v in stats.items()})}, "
            f"{report.tuning_hint()}; files "
            f"{sorted(p.name for p in (Path(tmp) / 'diag').iterdir())}")
        if not (len(report.segments) and all(np.isfinite(v) for v in stats.values())
                and (Path(tmp) / "diag" / "diarization.json").exists()):
            raise AssertionError("diag: no segments, non-finite statistics or no output")

    # -------------------------------------------------------- phase 4k ----
    seeded = seeded_encoders_phase(dev, vad, bench_cfg, der_pct, wave600,
                                   truth600, k2_w80)

    # -------------------------------------------------------- phase 4l ----
    published = published_graphs_phase(dev, enc, vad, bench_cfg, noisy_route,
                                       noisy600, y10)

    # ---------------------------------------------------------- phase 5 ----
    enc32 = load_speaker_encoder(wdir / "ecapa_robust_stream.npz")

    def card_and_cpu(cfg, wave):
        outs = {}
        for where in ("cuda", "cpu"):
            p = DiarizationPipeline(cfg, encoder=enc32, vad=load_vad(
                wdir / "vad_conv_mc.npz"), device=where)
            p._PAD_BUCKET_S = 10.0
            outs[where] = p(wave)
        return outs

    wave, truth = make_conversation(np.random.default_rng(3), 25.0, n_speakers=3,
                                    sr=SR)
    outs = card_and_cpu(bench_cfg(False), wave)
    g_c = outs["cuda"].diagnostics["window_embeddings"]
    g_p = outs["cpu"].diagnostics["window_embeddings"]
    cos = float(((g_c * g_p).sum(1) / np.linalg.norm(g_c, axis=1)
                 / np.linalg.norm(g_p, axis=1)).min())
    perr = float(np.abs(outs["cuda"].diagnostics["vad_probs"]
                        - outs["cpu"].diagnostics["vad_probs"]).max())
    ders = {k: der_pct(truth, v.segments) for k, v in outs.items()}
    log(f"[5] card vs CPU, 25 s / three chunks, float32 encoder: grid min cos "
        f"{cos:.6f} (bar 0.9999), VAD probs max err {perr:.2e} (bar 1e-3), "
        f"DER {ders['cuda']:.4f} % vs {ders['cpu']:.4f} %, speakers "
        f"{outs['cuda'].num_speakers} vs {outs['cpu'].num_speakers}")
    if not (cos > 0.9999 and perr < 1e-3
            and abs(ders["cuda"] - ders["cpu"]) <= 1.0
            and outs["cuda"].num_speakers == outs["cpu"].num_speakers):
        raise AssertionError("the card disagrees with the CPU reference")
    # the windowed grid (ecapa_synthetic.npz in float32, the energy VAD) on
    # the same file: its window embeddings on the card against the CPU
    enc_w32 = load_speaker_encoder(wdir / ENCODERS["windowed"])
    outs = {where: DiarizationPipeline(bench_cfg(False), encoder=enc_w32,
                                       device=where)(wave)
            for where in ("cuda", "cpu")}
    d_c, d_p = outs["cuda"].diagnostics, outs["cpu"].diagnostics
    g_c, g_p = d_c["window_embeddings"], d_p["window_embeddings"]
    cos = float(((g_c * g_p).sum(1) / np.linalg.norm(g_c, axis=1)
                 / np.linalg.norm(g_p, axis=1)).min()) if g_c.shape == g_p.shape else -1.0
    perr = float(np.abs(d_c["vad_probs"] - d_p["vad_probs"]).max())
    ders = {k: der_pct(truth, v.segments) for k, v in outs.items()}
    log(f"[5] card vs CPU, 25 s, windowed grid (float32 {ENCODERS['windowed']}, "
        f"energy VAD): grids {d_c.get('grid')} / {d_p.get('grid')} "
        f"{g_c.shape}, min cos {cos:.6f} (bar 0.9999), VAD probs max err "
        f"{perr:.2e} (bar 1e-3), DER {ders['cuda']:.4f} % vs {ders['cpu']:.4f} "
        f"%, speakers {outs['cuda'].num_speakers} vs {outs['cpu'].num_speakers}")
    if not (d_c.get("grid") == d_p.get("grid") == "windowed" and cos > 0.9999
            and perr < 1e-3 and abs(ders["cuda"] - ders["cpu"]) <= 1.0
            and outs["cuda"].num_speakers == outs["cpu"].num_speakers):
        raise AssertionError("the windowed grid on the card disagrees with the "
                             "CPU reference")
    # the same with the rescue and reassignment on, over a file that has
    # overlapped speech
    wave, truth = make_conversation_heldout(np.random.default_rng(4000), 25.0,
                                            n_speakers=3, sr=SR, overlap_frac=0.3)
    outs = card_and_cpu(bench_cfg(True, reseg=ResegConfig(enabled=True)), wave)
    d_c, d_p = outs["cuda"].diagnostics, outs["cpu"].diagnostics
    agree = agreement(d_c["overlap_hard"], d_p["overlap_hard"])
    r_c, r_p = d_c["overlap_regions"], d_p["overlap_regions"]
    s_c, s_p = outs["cuda"].segments, outs["cpu"].segments
    same_n = len(r_c) == len(r_p) and len(s_c) == len(s_p)
    r_err = max([0.0, *np.abs(r_c.starts - r_p.starts),
                 *np.abs(r_c.ends - r_p.ends)]) if same_n else float("inf")
    s_err = max([0.0, *np.abs(s_c.starts - s_p.starts),
                 *np.abs(s_c.ends - s_p.ends)]) if same_n else float("inf")
    ders = {k: der_pct(truth, v.segments) for k, v in outs.items()}
    log(f"[5] card vs CPU, held-out 25 s / three chunks, rescue and "
        f"reassignment on: equal hard decisions {100 * agree:.4f} % of "
        f"{d_c['overlap_hard'].size} (bar {100 * HARD_AGREE:.1f} %), "
        f"{len(r_c)} vs {len(r_p)} overlap regions (max edge difference "
        f"{r_err:.3f} s, bar 0.02), {len(s_c)} vs {len(s_p)} final segments "
        f"(max edge difference {s_err:.3f} s, bar 0.02), speakers equal: "
        f"{bool(same_n and (s_c.spks == s_p.spks).all())}, DER "
        f"{ders['cuda']:.4f} % vs {ders['cpu']:.4f} %")
    if not (agree >= HARD_AGREE and same_n and r_err <= 0.02 and s_err <= 0.02
            and (s_c.spks == s_p.spks).all()
            and abs(ders["cuda"] - ders["cpu"]) <= 1.0):
        raise AssertionError("the card disagrees with the CPU reference with "
                             "the overlap rescue on")
    # the whole-file path through GTCRN over a noisy file
    wave, truth = make_conversation_heldout(np.random.default_rng(11), 25.0,
                                            n_speakers=3, sr=SR, snr_db=10.0,
                                            noise_kind="white")
    outs = card_and_cpu(bench_cfg(True), wave)
    d_c, d_p = outs["cuda"].diagnostics, outs["cpu"].diagnostics
    s_c, s_p = outs["cuda"].segments, outs["cpu"].segments
    g_c, g_p = d_c["window_embeddings"], d_p["window_embeddings"]
    cos = float(((g_c * g_p).sum(1) / np.linalg.norm(g_c, axis=1)
                 / np.linalg.norm(g_p, axis=1)).min())
    perr = float(np.abs(d_c["vad_probs"] - d_p["vad_probs"]).max())
    same_n = len(s_c) == len(s_p)
    s_err = max([0.0, *np.abs(s_c.starts - s_p.starts),
                 *np.abs(s_c.ends - s_p.ends)]) if same_n else float("inf")
    ders = {k: der_pct(truth, v.segments) for k, v in outs.items()}
    log(f"[5] card vs CPU, 25 s in white noise at 10 dB (whole-file path, "
        f"GTCRN): routes {d_c.get('route')} / {d_p.get('route')}, est SNR "
        f"{d_c['snr_db']:.4f} / {d_p['snr_db']:.4f} dB, VAD probs max err "
        f"{perr:.2e} (bar 1e-3), grid min cos {cos:.6f} (bar 0.9999), "
        f"{len(s_c)} vs {len(s_p)} final segments (max edge difference "
        f"{s_err:.3f} s, bar 0.02), DER {ders['cuda']:.4f} % vs "
        f"{ders['cpu']:.4f} %")
    if not (d_c.get("route") == d_p.get("route") == "legacy" and perr < 1e-3
            and cos > 0.9999 and s_err <= 0.02 and (s_c.spks == s_p.spks).all()
            and abs(ders["cuda"] - ders["cpu"]) <= 1.0):
        raise AssertionError("the card disagrees with the CPU reference on "
                             "the noisy-input route")

    # ---------------------------------------------------------- phase 6 ----
    training = training_phase(dev, smi, bench_cfg, der_pct)
    rows[0]["training"] = training["k2"]

    # ---------------------------------------------------------- phase 7 ----
    surface = surface_phase(dev, enc)
    rows[0]["chunked_vad"] = surface["call_forms"]["k2"]

    # ---------------------------------------------------------- phase 8 ----
    parallel = parallel_phase(dev, smi, enc, vad, bench_cfg, der_pct)
    rows[0]["sharded"] = {**parallel["k2"], "launches_encode": {
        k: v["k2_shapes"] for k, v in parallel["encode"].items() if k != "single_ms"}}
    rows[1]["sharded"] = {"asp_check": parallel["asp"]}

    # ---------------------------------------------------------- phase 9 ----
    tools = tools_phase(dev)
    rows[0]["probe_batch"] = {**tools["k2"], "launches": tools["shapes"].get(K2_PROBE, 0)}
    rows[1]["probe_grid"] = {**tools["k1"], "launches": tools["shapes"].get(K1_PROBE, 0)}

    for r in rows:
        # this slice's path: the bench configuration at the shipped default
        r["launches"] = launches[True, 600][r["name"]]
        r["launches_overlap_off"] = launches[False, 600][r["name"]]
        # phase 7: the non-WAV CLI run, the web UI's pipeline and the traced call
        r["launches_surface"] = surface["launches"][r["name"]]
        # phase 8: the sharded encoder, corpus route, K1 check, mesh steps and
        # dry runs on virtual meshes of the card
        r["launches_parallel"] = parallel["launches"][r["name"]]
        # phase 9: the evaluation tools' card runs
        r["launches_tools"] = tools["launches"][r["name"]]
        # the noisy-input route on the 600 s file in white noise, through
        # GTCRN, ZipEnhancer and the demixer
        r["launches_noisy"] = noisy["white", 10.0, 600]["launches"][r["name"]]
        for backend in ("zipenhancer", "demix-dialog"):
            r[f"launches_{backend.split('-')[0]}"] = (
                enhanced[backend, "white", 10.0, 600]["launches"][r["name"]])
        # phase 4l: the published graphs on the same file, and their 60 s
        # routes counted by shape
        for tag, run in published["runs"].items():
            r[f"launches_{tag}"] = run["launches"][r["name"]]
            r.setdefault("launch_shapes_published", {})[tag] = {
                k: v for k, v in run["shapes"].items() if k.startswith(r["name"])}
    rows[0]["batch"]["launches"] = forms[True, 600]["fused_log_mel[B, T]"]
    rows[0]["batch_vad"]["launches"] = (
        noisy["white", 10.0, 600]["forms"]["fused_log_mel[B, T]"])
    # phase 4e's runs, counted by shape at the point of launch: K1 at A 32
    # (padded to 64) and A 128 and K2's [T] at 80 mels on the 60 s draw,
    # the windowed grid's batches at 40 mels per 600 s and at 80 mels (the
    # full-width encoder on the windowed grid) on the 60 s draw
    rows[1]["a32"]["launches_60s"] = opt_shapes["proto_small"][k1_a64_384]
    rows[1]["a128"]["launches_60s"] = opt_shapes["full_stream"][k1_a128]
    rows[0]["t_80"]["launches_60s"] = opt_shapes["full_stream"][k2_t80]
    rows[0]["batch_windowed_40"]["launches"] = opt_shapes["windowed_600"][k2_w40]
    rows[0]["batch_windowed_80"]["launches_60s"] = (
        opt_shapes["full_stream_windowed"][k2_w80])
    rows[0]["launches_options"] = {k: v["fused_log_mel"] for k, v in opt_launches.items()}
    # phase 4k: the windowed grid at 80 mels with each seeded encoder on
    # the 60 s draw, and with ERes2NetV2 on the 600 s draw
    rows[0]["batch_windowed_80"]["launches_encoders_60s"] = {
        tag: r["shapes"].get(k2_w80, 0) for tag, r in seeded["runs"].items()}
    rows[0]["batch_windowed_80"]["launches_eres2netv2_600s"] = (
        seeded["shapes600"].get(k2_w80, 0))
    # this slice's routes, counted by shape where launched: the engine's
    # chunks and grid at 60 s and 600 s (4h), the bucketed snippets (4i)
    rows[0]["engine_chunks_60s"]["launches"] = engine["conv", "bench_60s"]["shapes"][k2_chunks]
    rows[0]["engine_chunks_600s"]["launches"] = engine["conv", "bench_600s"]["shapes"][k2_chunks]
    rows[0]["engine_grid"]["launches"] = {
        tag: engine["conv", tag]["shapes"][k2_grid1] for tag in ("bench_60s", "bench_600s")}
    for blen, m in rows[0]["bucketed"].items():
        m["launches"] = buckets.get(blen, 0)
        m["launches_600s"] = buckets600.get(blen, 0)
    rows[0]["launches_engine"] = {f"{n} {t}": v["launches"]["fused_log_mel"]
                                  for (n, t), v in engine.items()}
    rows[1]["launches_engine"] = {f"{n} {t}": v["launches"]["asp_grid_stats"]
                                  for (n, t), v in engine.items()}
    rows[1]["launches_options"] = {k: v["asp_grid_stats"] for k, v in opt_launches.items()}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_overlap_off", "launches_surface", "launches_noisy", "launches_zipenhancer",
            "launches_demix", "launches_zipenhancer-ref_white10_600s",
            "launches_htdemucs_white10_600s", "launch_shapes_published",
            "launches_options", "launches_engine", "batch",
            "batch_vad", "t_80", "batch_windowed_40", "batch_windowed_80", "a32",
            "a128", "engine_chunks_60s", "engine_chunks_600s", "engine_grid",
            "bucketed", "training", "launches_parallel", "sharded",
            "launches_tools", "probe_batch", "probe_grid", "chunked_vad")
    log(f"[end] engine 600 s {engine['conv', 'bench_600s']['wall']:.4f} s, bucketed "
        f"60 s {bucketed_wall:.4f} s, batch {({k: round(v, 3) for k, v in batch_walls.items()})} "
        f"s, diag {diag_wall:.3f} s, encoders 60 s "
        f"{({k: round(v['wall'], 4) for k, v in seeded['runs'].items()})} s, "
        f"eres2netv2 600 s {seeded['wall600']:.4f} s, published graphs "
        f"{({k: round(v['wall'], 4) for k, v in published['runs'].items()})} s, "
        f"training steps {({k: round(v['step_ms'], 3) for k, v in training['configs'].items()})} ms, "
        f"surface phase {surface['wall']:.1f} s; parallel phase "
        f"{parallel['wall']:.1f} s (corpus 600 s sharded "
        f"{parallel['corpus'][600]['wall_sharded_s']:.4f} s vs "
        f"{parallel['corpus'][600]['wall_single_s']:.4f} s, mesh steps "
        f"{({k: round(v['step_ms_mesh'], 3) for k, v in parallel['train'].items()})} ms); "
        f"tools phase {tools['wall']:.1f} s (card / CPU walls "
        f"{({k: (round(v['wall_s'], 3), round(v['wall_cpu_s'], 3)) for k, v in tools['tools'].items()})} s); "
        f"the whole run took "
        f"{time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark of the PyTorch port: full-pipeline real-time factor on one card.

The protocol of the JAX package's ``bench.py`` for its first three
milestones, on the same files and configuration:

0. device contact (a small product on the card, timed);
1. the 60 s draw: one warm call (it builds the CUDA kernels the first time),
   then the minimum of 4 timed calls;
2. the 600 s draw (``SDTPU_BENCH_FULL_S`` overrides the length): the same,
   skipped when the 60 s speed says it would pass ``SDTPU_BENCH_BUDGET_S``;
3. corpus throughput (``SDTPU_BENCH_CORPUS=0`` skips it): six draws
   ``make_conversation(default_rng(40 + i), FULL_S)`` as ``(wave, sr)``
   pairs through ``pipelines/corpus.py::corpus_diarize`` on the one
   pipeline, ``SDTPU_BENCH_CORPUS_PASSES`` (3) passes.  Each file's wall is
   its minimum over the passes; the censored aggregate is the sum of those
   minima plus the smallest time a pass spent outside its files, beside the
   raw best pass; corpus DER is the mean over the six files.  A corpus
   error, or a corpus DER more than one point from the JAX pipeline's on
   the CPU on the same draws, either way (``scripts/torch_port_der_bar.py
   --corpus``), exits nonzero (``bench.py`` logs corpus failures and goes on; this does not);
3.5. the embed chunk's roofline (``SDTPU_BENCH_MFU=0`` skips it): the
   streaming grid's chunk (600 windows of 2 s at a 0.1 s hop, 4 s margins)
   on the bf16 trunk, timed in a blocking loop and as back-to-back calls on
   CUDA events (``_onchip``); its operations and bytes from
   ``utils/profiling.py::model_complexity`` (the kernels' analytic counts
   included) against the H100's peaks (``ops/cost.py``);
4. K1 under sharding (``SDTPU_BENCH_SHARDED_ASP=0`` skips it): a mesh over
   every local card, each dp replica running the streaming grid's chunk
   through K1 (``encode_grid_chunk(..., backend='kernel')``) on its own
   seeded chunk (600 windows, margins 4 s, the bf16 trunk), against the
   single-device decomposed head on the same chunks: the minimum cosine
   must exceed 0.9999 (the JAX bar), and K1 must run once a replica
   (``sharded_asp_dp``, ``sharded_asp_min_cos``);
5. opt-in (``SDTPU_BENCH_FBANK=1``): kernel K2 against the plain log-mel on
   a ``[512, 16000]`` batch (CUDA events).

A milestone that fails raises, and the script exits nonzero; no value is
carried over from an earlier run (``bench.py`` falls back to a last-good
file; this does not).

Files are ``make_conversation(np.random.default_rng(0), D, n_speakers=3)``;
the configuration is spectral clustering (max 8 speakers), the shipped
``vad_conv_mc.npz`` and ``ecapa_robust_stream.npz`` (bf16 trunk) and the
overlap rescue at its config default (on, ``segmentation_conv.npz``);
``SDTPU_BENCH_OVERLAP=0`` or ``1`` overrides it, as in ``bench.py``.  Frame
reassignment is off, as in the config default.  Every run is scored: DER
against the generator truth rides each line.

    python3 scripts/torch_bench.py [--cpu]

One JSON line per milestone on standard output, the last one the headline;
stage timings go to standard error (``SDTPU_LOG_LEVEL=INFO``).  Needs a CUDA
card unless ``--cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SR = 16000
SMALL_S = 60.0
FULL_S = float(os.environ.get("SDTPU_BENCH_FULL_S", "600"))
FULL_BUDGET_S = float(os.environ.get("SDTPU_BENCH_BUDGET_S", "300"))
# mean DER (%, collar 0.25 s) of the JAX pipeline on the CPU over the six
# 600 s corpus draws, overlap rescue on (scripts/torch_port_der_bar.py
# --corpus)
JAX_CPU_CORPUS_DER_PCT = 0.3907
DER_SLACK_PCT = 1.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(rtf: float, scope: str, extra: dict) -> None:
    """Print a complete, parsable result line; later lines supersede."""
    print(json.dumps({"metric": "diarization_rtf_per_chip",
                      "value": round(rtf, 2), "unit": "x_realtime",
                      "scope": scope, **extra}), flush=True)


def run_milestone(pipe, dur: float, tag: dict, score) -> tuple[float, float, float]:
    """Warm call + min of 4 timed calls on the ``dur``-second draw; prints the
    warm line and returns (rtf, der_pct, wall_s)."""
    from speech_diarization_tpu_torch.train.synthetic import make_conversation

    wave, truth = make_conversation(np.random.default_rng(0), dur,
                                    n_speakers=3, sr=SR)
    t0 = time.perf_counter()
    result = pipe((wave, SR))
    warm = time.perf_counter() - t0
    der = score(result, truth)
    log(f"[{dur:.0f}s] warm call: {warm:.2f}s, {len(result.segments)} segments, "
        f"{result.num_speakers} speakers, der {der:.2f}%")
    emit(dur / warm, f"{dur:.0f}s_warmup_incl_build", {"der_pct": der, **tag})
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        pipe((wave, SR))
        times.append(time.perf_counter() - t0)
    wall = min(times)
    log(f"[{dur:.0f}s] timed: {[f'{t:.3f}' for t in times]} -> rtf "
        f"{dur / wall:.1f}x")
    return dur / wall, der, wall


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()
    os.environ.setdefault("SDTPU_LOG_LEVEL", "INFO")

    import torch

    from speech_diarization_tpu_torch.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig, OverlapConfig,
    )
    from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
    from speech_diarization_tpu_torch.models.port import (
        load_speaker_encoder, load_vad,
    )
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.types import SegmentArray
    from speech_diarization_tpu_torch.utils.weights import (
        ENCODER_PREFERENCE, VAD_PREFERENCE, prefer_weights,
    )

    if not args.cpu and not torch.cuda.is_available():
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    # -- milestone 0: device contact ------------------------------------------
    t0 = time.perf_counter()
    if args.cpu:
        card = "cpu"
    else:
        x = torch.ones((256, 256), dtype=torch.bfloat16, device="cuda")
        (x @ x).sum().item()
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {card}, first contact {time.perf_counter() - t0:.2f}s")

    ov_env = os.environ.get("SDTPU_BENCH_OVERLAP")
    overlap_cfg = (OverlapConfig(enabled=ov_env == "1") if ov_env is not None
                   else OverlapConfig())
    log(f"overlap rescue: {'on' if overlap_cfg.enabled else 'off'}")
    cfg = DiarizationConfig(
        cluster=ClusterConfig(method="spectral", max_speakers=8),
        embed=EmbedConfig(grid_backend="auto"), overlap=overlap_cfg)
    enc_w, vad_w = prefer_weights(ENCODER_PREFERENCE), prefer_weights(VAD_PREFERENCE)
    log(f"encoder: {enc_w.name} (bf16 trunk); vad: {vad_w.name}")
    pipe = DiarizationPipeline(
        cfg, encoder=load_speaker_encoder(enc_w, dtype=torch.bfloat16),
        vad=load_vad(vad_w), device="cpu" if args.cpu else None)
    tag = {"card": card, "overlap": overlap_cfg.enabled}

    def score(result, truth) -> float:
        return round(100.0 * diarization_error_rate(
            SegmentArray(*truth), result.segments).der, 2)

    # -- milestone 1: 60 s ----------------------------------------------------
    small_rtf, small_der, small_wall = run_milestone(pipe, SMALL_S, tag, score)
    emit(small_rtf, "60s_bucket", {"wall_s": round(small_wall, 4),
                                   "der_pct": small_der, **tag})
    # -- milestone 2: the headline run ------------------------------------------
    est_wall = FULL_S / max(small_rtf, 1e-3)
    if est_wall > FULL_BUDGET_S:
        log(f"[{FULL_S:.0f}s] skipped: estimated {est_wall:.0f}s exceeds budget "
            f"{FULL_BUDGET_S:.0f}s; keeping the 60 s result")
        return 0
    rtf, der, wall = run_milestone(pipe, FULL_S, tag, score)
    extra = {"wall_s": round(wall, 4), "rtf_60s_bucket": round(small_rtf, 2),
             "der_pct": der, "der_60s_pct": small_der, **tag}
    emit(rtf, f"{int(FULL_S)}s_full", extra)
    if os.environ.get("SDTPU_BENCH_CORPUS", "1") == "1":
        if corpus_milestone(pipe, cfg, score, extra) != 0:
            return 1
        emit(rtf, f"{int(FULL_S)}s_full", extra)
    if args.cpu:
        return 0
    # -- milestone 3.5: the embed chunk's roofline -------------------------------
    if os.environ.get("SDTPU_BENCH_MFU", "1") == "1":
        mfu = mfu_micro_bench(pipe.encoder)
        log(f"mfu micro-bench: {mfu}")
        extra.update(mfu)
        emit(rtf, f"{int(FULL_S)}s_full", extra)
    # -- milestone 4: K1 under sharding -------------------------------------------
    if os.environ.get("SDTPU_BENCH_SHARDED_ASP", "1") == "1":
        sh = sharded_asp_check(pipe.encoder)
        log(f"sharded K1 check: {sh}")
        extra.update(sh)
        emit(rtf, f"{int(FULL_S)}s_full", extra)
    # -- milestone 5 (opt-in): K2 against the plain log-mel ----------------------
    if os.environ.get("SDTPU_BENCH_FBANK", "0") == "1":
        fb = fbank_micro_bench()
        log(f"fbank micro-bench: {fb}")
        emit(rtf, f"{int(FULL_S)}s_full", {**extra, **fb})
    return 0


def corpus_milestone(pipe, cfg, score, extra: dict) -> int:
    """Milestone 3: corpus throughput; adds its keys to ``extra``; 1 on a
    corpus error or a DER off the JAX CPU bar."""
    from speech_diarization_tpu_torch.pipelines.corpus import corpus_diarize
    from speech_diarization_tpu_torch.train.synthetic import make_conversation

    pairs = [make_conversation(np.random.default_rng(40 + i), FULL_S,
                               n_speakers=3, sr=SR) for i in range(6)]
    files = [(wv, SR) for wv, _ in pairs]
    n_pass = int(os.environ.get("SDTPU_BENCH_CORPUS_PASSES", "3"))
    raw_wall, overhead, file_walls, report = float("inf"), float("inf"), {}, None
    for _ in range(n_pass):
        t0 = time.perf_counter()
        report = corpus_diarize(files, cfg, pipeline_factory=lambda: pipe,
                                keep_results=True)
        w = time.perf_counter() - t0
        if report.errors:
            log(f"[corpus] errors: {report.errors}")
            return 1
        raw_wall = min(raw_wall, w)
        for f in report.files:
            file_walls[f["index"]] = min(file_walls.get(f["index"], float("inf")),
                                         f["wall_s"])
        overhead = min(overhead, max(0.0, w - sum(f["wall_s"] for f in report.files)))
    cwall = sum(file_walls.values()) + overhead
    ders = {f["index"]: score(f["result"], pairs[f["index"]][1])
            for f in report.files}
    for i in sorted(ders):
        log(f"[corpus] file {i}: der {ders[i]:.2f}% best wall {file_walls[i]:.4f}s")
    corpus_der = round(float(np.mean(list(ders.values()))), 4)
    fw = sorted(file_walls.values())
    log(f"[corpus] 6x{int(FULL_S)}s: censored {cwall:.4f}s -> "
        f"{6 * FULL_S / cwall:.1f}x (raw best pass {raw_wall:.4f}s -> "
        f"{6 * FULL_S / raw_wall:.1f}x; per-file walls min {fw[0]:.4f} max "
        f"{fw[-1]:.4f}s over {n_pass} passes; mean der {corpus_der}%)")
    extra.update({"corpus_rtf": round(6 * FULL_S / cwall, 2),
                  "corpus_rtf_raw": round(6 * FULL_S / raw_wall, 2),
                  "corpus_file_wall_min_s": round(fw[0], 4),
                  "corpus_file_wall_max_s": round(fw[-1], 4),
                  "corpus_overhead_s": round(overhead, 4),
                  "corpus_der_pct": corpus_der,
                  "corpus_der_pct_files": [ders[i] for i in sorted(ders)]})
    if FULL_S == 600.0:
        if not abs(corpus_der - JAX_CPU_CORPUS_DER_PCT) <= DER_SLACK_PCT:
            log(f"[corpus] DER {corpus_der}% more than {DER_SLACK_PCT} point "
                f"from the JAX CPU {JAX_CPU_CORPUS_DER_PCT}%")
            return 1
    return 0


def mfu_micro_bench(encoder, iters: int = 5, k: int = 16) -> dict:
    """Milestone 3.5 (``bench.py::_mfu_micro_bench``) on the card: the
    streaming grid's chunk (600 windows of 2 s at a 0.1 s hop with 4 s
    margins: one K2 launch, the trunk, one K1 launch) of ``encoder`` on a
    seeded draw.  ``embed_chunk_ms`` is the mean of ``iters`` blocking
    calls (each synchronized); the ``_onchip`` keys time ``k``
    back-to-back calls on CUDA events.  Operations and bytes are
    ``model_complexity``'s (products only; bytes with no fusion; K1's and
    K2's analytic counts added), against the H100's bf16 tensor peak and
    memory rate."""
    import torch

    from speech_diarization_tpu_torch.ops.cost import PEAK_BYTES_S, PEAK_FLOPS
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.utils.profiling import (
        cuda_time_ms, model_complexity,
    )

    win, hop, wpc = 2 * SR, SR // 10, 600
    margin = 4 * SR
    span = 2 * margin + (wpc - 1) * hop + win
    seg = torch.from_numpy(np.random.default_rng(0).standard_normal(span)
                           .astype(np.float32)).cuda()

    def chunk():
        return encoder.encode_grid_chunk(seg, wpc, margin, win, hop)

    out = {}
    with torch.inference_mode():
        with kernels.tally() as launched:
            cost = model_complexity(chunk)
        k1 = [w for name, w in launched if name == "asp_grid_stats"]
        k2 = [w for name, w in launched if name == "fused_log_mel"]
        if len(k1) != 1 or len(k2) != 1:
            raise RuntimeError(f"the embed chunk launched K1 {len(k1)} and K2 "
                               f"{len(k2)} times (expected once each)")
        flops, nbytes = cost["flops"], cost["bytes_accessed"]
        out["asp_kernel_gflops"] = round(k1[0]["flops"] / 1e9, 4)
        out["fbank_kernel_gflops"] = round(k2[0]["flops"] / 1e9, 4)
        chunk()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            chunk()
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / iters
        dtc = cuda_time_ms(chunk, k) / 1e3
    peak = PEAK_FLOPS["bf16_tensor"]
    out["embed_chunk_ms"] = round(dt * 1e3, 4)
    out["embed_gflops"] = round(flops / 1e9, 4)
    out["embed_gbytes"] = round(nbytes / 1e9, 4)
    out["mfu_embed"] = round(flops / dt / peak, 5)
    out["embed_hbm_frac"] = round(nbytes / dt / PEAK_BYTES_S, 5)
    out["embed_arith_intensity"] = round(flops / max(nbytes, 1.0), 2)
    out["embed_chunk_ms_onchip"] = round(dtc * 1e3, 4)
    out["mfu_embed_onchip"] = round(flops / dtc / peak, 5)
    out["embed_hbm_frac_onchip"] = round(nbytes / dtc / PEAK_BYTES_S, 5)
    return out


def sharded_asp_check(encoder, devices=None) -> dict:
    """Milestone 4 (``bench.py::_sharded_asp_check``): K1 under a dp mesh
    over ``devices`` (every local card by default).  Replica ``i`` of
    ``parallel.make_sharded_encode_fn`` runs ``encode_grid_chunk`` through
    K1 on chunk ``i`` of a seeded batch (600 windows of 2 s at a 0.1 s hop,
    4 s margins); the single-device decomposed head runs the same chunks.
    Raises unless the minimum cosine exceeds 0.9999 and K1 ran once a
    replica."""
    import torch

    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.parallel import make_mesh, make_sharded_encode_fn

    win, hop, wpc = 2 * SR, SR // 10, 600
    margin = 4 * SR
    span = 2 * margin + (wpc - 1) * hop + win
    mesh = make_mesh(devices=devices)
    n = mesh.shape["dp"]
    batch = torch.from_numpy(np.random.default_rng(7).standard_normal((n, span))
                             .astype(np.float32))
    sharded = make_sharded_encode_fn(encoder, None, mesh)
    dev = next(encoder.parameters()).device
    with torch.inference_mode():
        before = kernels.LAUNCHES["asp_grid_stats"]
        out_k = [sharded.call(i, "encode_grid_chunk", batch[i].to(mesh.devices[i, 0]),
                              wpc, margin, win, hop, backend="kernel").to(dev)
                 for i in range(n)]
        launched = kernels.LAUNCHES["asp_grid_stats"] - before
        out_d = [encoder.encode_grid_chunk(batch[i].to(dev), wpc, margin, win, hop,
                                           backend="decomposed") for i in range(n)]
        a, b = torch.cat(out_k).double(), torch.cat(out_d).double()
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1) + 1e-9)
        min_cos = float(cos.min())
    if launched != n:
        raise RuntimeError(f"K1 ran {launched} times for {n} replicas")
    if not min_cos > 0.9999:
        raise RuntimeError(f"sharded K1 diverges: min cos {min_cos}")
    return {"sharded_asp_dp": n, "sharded_asp_min_cos": round(min_cos, 7),
            "sharded_asp_k1_launches": launched}


def fbank_micro_bench(batch: int = 512, t: int = 16000, iters: int = 20) -> dict:
    """Milestone 5 (``bench.py::_fbank_micro_bench``) on the card: K2
    (``fused_log_mel``) against the plain log-mel (the framed matrix-product
    form, the JAX 'matmul' backend) on a seeded ``[batch, t]`` batch, 40
    mels (the encoder's front end); each the mean of ``iters`` calls on
    CUDA events, with K2's largest difference from the plain output."""
    import torch

    from speech_diarization_tpu_torch.dsp.mel import fused_log_mel, log_mel_spectrogram
    from speech_diarization_tpu_torch.utils.profiling import cuda_time_ms

    wavs = torch.from_numpy(np.random.default_rng(0).standard_normal((batch, t))
                            .astype(np.float32)).cuda()
    with torch.inference_mode():
        err = (fused_log_mel(wavs, n_mels=40)
               - log_mel_spectrogram(wavs, n_mels=40)).abs().max().item()
        return {"fbank_shape": [batch, t],
                "fbank_fused_ms": round(cuda_time_ms(
                    lambda: fused_log_mel(wavs, n_mels=40), iters), 4),
                "fbank_matmul_ms": round(cuda_time_ms(
                    lambda: log_mel_spectrogram(wavs, n_mels=40), iters), 4),
                "fbank_max_abs_err": err}


if __name__ == "__main__":
    sys.exit(main())

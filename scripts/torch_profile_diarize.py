"""Where the time goes in the PyTorch port's diarizer, on one CUDA card.

Runs the port's main path as ``chip_smoke.py`` does (bench configuration,
shipped VAD, bf16 encoder and overlap detector) on the bench's 600 s
generator draw, after a warm-up, first with the overlap rescue off and then
with it on (the shipped default), and reports for each:

* host wall of each phase: dispatch (quantize, pinned upload, SNR probe,
  per-chunk programs queued), the wait for the device and the packed copy,
  and each host-tail stage (from the pipeline's stage timers);
* from ``torch.profiler`` over one run: device time by kernel and the
  device's busy share of the wall (sum of kernel times over the wall; the
  port uses one stream).

Then what the detector adds: the difference of the two runs by kernel (device
time and calls) and by host phase.

``--noisy`` profiles the noisy-input route instead, at the config's defaults
on ``make_conversation_heldout(rng(0), seconds, n_speakers=3, snr_db=10,
noise_kind='white')``: the whole-file path through the enhancer of
``--enhance`` (default GTCRN).  Host wall by stage, device time by kernel
and busy share as above, then the enhancer alone on the file's padded
waveform: GTCRN by module (CUDA events around each encoder block, DPGRNN
and decoder block, and around each of its GRUs apart) and the STFT / iSTFT
around the net; ZipEnhancer split into its linears, the attention proper
(the attention modules less their linears and norms) and the rest, with
peak device memory, by batch of 64 windows; the demixer as K3's
resampling each way and the separator, each on the card's clock.

``--engine`` profiles the segmentation engine instead, at its defaults
(``segmentation_conv.npz``, the bf16 encoder, spectral clustering) on the
bench draw: host wall by stage (``seg-score``: upload, one log-mel launch
for every chunk, the net and the copy back; ``seg-local``: binarize,
center-trim and purity rows; ``seg-embed-grid``: the 1 s window grid
through the encoder; ``seg-embeddings``: the purity-masked pools;
``seg-cluster``), the number of local segments, peak device memory, and
device time by kernel with the busy share.

    python3 scripts/torch_profile_diarize.py [--seconds 600] [--overlap off|on|both]
    python3 scripts/torch_profile_diarize.py --engine [--seconds 600]
    python3 scripts/torch_profile_diarize.py --noisy [--seconds 600] [--enhance gtcrn|zipenhancer|demix-dialog]

Prints a table and one JSON line.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import logging
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SR = 16000
# __global__ functions of speech_diarization_tpu_torch/csrc/*.cu
PORT_KERNELS = ("fused_log_mel_kernel", "asp_preproj_kernel", "asp_window_kernel")


class _StageLog(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.walls: dict[str, float] = {}

    def emit(self, record):
        m = re.match(r"stage=(\S+) wall_s=([0-9.]+)", record.getMessage())
        if m:
            self.walls[m.group(1)] = float(m.group(2))
        m = re.match(r"segmentation: (\d+) local", record.getMessage())
        if m:
            self.walls["local_segments"] = int(m.group(1))


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def profile_config(seconds: float, overlap: bool, smi: str) -> dict:
    """Host phases, device time by kernel and busy share of one
    configuration; prints its table and returns the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speech_diarization_tpu_torch.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig, OverlapConfig,
    )
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.synthetic import make_conversation
    from speech_diarization_tpu_torch.utils.logging import get_logger

    cfg = DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8),
                            embed=EmbedConfig(grid_backend="auto"),
                            overlap=OverlapConfig(enabled=overlap))
    w = ROOT / "weights"
    pipe = DiarizationPipeline(
        cfg, encoder=load_speaker_encoder(w / "ecapa_robust_stream.npz",
                                          dtype=torch.bfloat16),
        vad=load_vad(w / "vad_conv_mc.npz"))
    wave, _ = make_conversation(np.random.default_rng(0), seconds,
                                n_speakers=3, sr=SR)
    pipe(wave)                                   # warm-up (builds kernels)

    logger = get_logger("diarize")
    handler = _StageLog()
    logger.addHandler(handler)
    root = logging.getLogger("sdtpu")
    old_level = root.level
    root.setLevel(logging.INFO)
    phases = []
    for _ in range(3):
        handler.walls = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = pipe.stream_start(wave)
        t1 = time.perf_counter()
        st["done"].synchronize()
        t2 = time.perf_counter()
        pipe.stream_finish(st)
        t3 = time.perf_counter()
        phases.append({"dispatch_s": t1 - t0, "device_wait_s": t2 - t1,
                       "host_tail_s": t3 - t2, "wall_s": t3 - t0,
                       **{f"tail_{k}_s": v for k, v in handler.walls.items()}})
    root.setLevel(old_level)
    logger.removeHandler(handler)
    best = min(phases, key=lambda p: p["wall_s"])
    # the dispatch phase's host pieces, timed alone (best of 3)
    t_pad = -(-len(wave) // (60 * SR)) * 60 * SR
    pieces = {"quantize_s": [], "snr_probe_s": [], "pin_s": []}
    for _ in range(3):
        t0 = time.perf_counter()
        q, scale = pipe._quantize_host(wave, t_pad)
        t1 = time.perf_counter()
        pipe._host_snr_db(q[:len(wave)].astype(np.float32) * (scale / 32767.0))
        t2 = time.perf_counter()
        torch.from_numpy(q).pin_memory()
        t3 = time.perf_counter()
        for k, v in zip(pieces, (t1 - t0, t2 - t1, t3 - t2)):
            pieces[k].append(v)
    best.update({f"dispatch_{k}": min(v) for k, v in pieces.items()})

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = _device_kernels(prof)
    busy_us = sum(v for _, v, _ in kern)
    print(f"card: {smi}; {seconds:.0f} s file; overlap rescue "
          f"{'on' if overlap else 'off'}")
    print(f"best of 3 host phases: " + ", ".join(
        f"{k} {v:.4f}" for k, v in best.items()))
    print(f"profiled wall {wall:.4f} s; device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.2f} % of the wall)")
    print(f"{'device time (ms)':>17} {'calls':>6}  name")
    for name, v, n in kern[:20]:
        print(f"{v / 1e3:17.3f} {n:6d}  {name[:90]}")
    # the port's own kernels, wherever they rank
    own = [r for r in kern if any(k in r[0] for k in PORT_KERNELS)]
    for name, v, n in own:
        if (name, v, n) not in kern[:20]:
            print(f"{v / 1e3:17.3f} {n:6d}  {name[:90]}")
    out = {
        "card": smi, "seconds": seconds, "overlap": overlap,
        "host_phases_best": best,
        "profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "top_kernels_ms": {name[:80]: v / 1e3 for name, v, _ in kern[:12]},
        "port_kernels_ms": {name[:80]: v / 1e3 for name, v, _ in own},
    }
    print(json.dumps(out))
    out["kernels"] = {name: (v / 1e3, n) for name, v, n in kern}
    return out


def _device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device us, calls) of the device-side entries of a profile,
    largest first (CPU ops also carry their children's device time, which
    would count each kernel twice)."""
    from torch.autograd import DeviceType

    kern = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        v = getattr(e, "self_device_time_total", None)
        if v is None:
            v = getattr(e, "self_cuda_time_total", 0.0)
        if v and v > 0:
            kern.append((e.key, float(v), e.count))
    return sorted(kern, key=lambda r: -r[1])


def gtcrn_by_module(enhancer, y) -> dict:
    """GTCRN on ``y`` with CUDA events around each top-level block and each
    GRU (the GRUs nested in a block are also in its time)."""
    import torch

    net = enhancer.net
    blocks = ([f"encoder.en_convs.{i}" for i in range(5)] + ["dpgrnn1", "dpgrnn2"]
              + [f"decoder.de_convs.{i}" for i in range(5)])
    grus = [n for n, m in net.named_modules() if isinstance(m, torch.nn.GRU)]
    spans: dict[str, list] = {}
    hooks = []
    for name in blocks + grus + [""]:
        mod = net.get_submodule(name)

        def pre(_m, _a, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans.setdefault(name, []).append([e, None])

        def post(_m, _a, _o, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans[name][-1][1] = e

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    enhancer(y)                                  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    spans.clear()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    enhancer(y)
    e1.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()}
    total = e0.elapsed_time(e1)
    net_ms = ms.pop("")
    out = {"enhancer_ms": total, "net_ms": net_ms, "stft_istft_ms": total - net_ms,
           "blocks_ms": {b: ms[b] for b in blocks},
           "grus_ms": {g: ms[g] for g in grus}}
    time_grus = [g for g in grus if "intra_rnn" not in g]
    out["time_grus_ms"] = sum(ms[g] for g in time_grus)
    out["intra_grus_ms"] = sum(ms[g] for g in grus if "intra_rnn" in g)
    out["not_gru_ms"] = net_ms - out["time_grus_ms"] - out["intra_grus_ms"]
    return out


def _event_spans(modules: dict, run) -> tuple[dict, float]:
    """CUDA events around every call of each named module while ``run()``
    runs (after one warm-up run): (ms by name, total ms)."""
    import torch

    spans: dict[str, list] = {}
    hooks = []
    for name, mod in modules.items():
        def pre(_m, _a, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans.setdefault(name, []).append([e, None])

        def post(_m, _a, _o, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            spans[name][-1][1] = e

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    run()
    torch.cuda.synchronize()
    spans.clear()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    return ({k: sum(a.elapsed_time(b) for a, b in v) for k, v in spans.items()},
            e0.elapsed_time(e1))


def zipenhancer_by_part(y) -> dict:
    """ZipEnhancer (shipped weights) through ``windowed_enhance`` on ``y``:
    linears, attention proper, the rest; time and peak memory of one batch
    of 64 windows."""
    import torch

    from speech_diarization_tpu_torch.models.port import load_zipenhancer
    from speech_diarization_tpu_torch.models.zipenhancer import _Attention
    from speech_diarization_tpu_torch.pipelines.enhance import windowed_enhance

    net = load_zipenhancer(ROOT / "weights" / "zipenhancer_mc.npz").cuda()
    mods = {n: m for n, m in net.named_modules()
            if isinstance(m, (_Attention, torch.nn.Linear, torch.nn.LayerNorm))}
    with torch.inference_mode():
        ms, total = _event_spans(mods, lambda: windowed_enhance(net, y))
        linears = sum(v for k, v in ms.items() if isinstance(mods[k], torch.nn.Linear))
        att_mods = [k for k in ms if isinstance(mods[k], _Attention)]
        attention = sum(ms[k] - sum(v for j, v in ms.items() if j.startswith(k + "."))
                        for k in att_mods)
        x64 = y[:63 * 24000 + 32000].unfold(0, 32000, 24000)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, batch_ms = _event_spans({}, lambda: net(x64))
        peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    return {"enhancer_ms": total, "linears_ms": linears, "attention_ms": attention,
            "rest_ms": total - linears - attention, "batch64_ms": batch_ms,
            "batch64_peak_gb_above_resident": peak}


def demix_by_part(y) -> dict:
    """The demix-dialog enhancer's legs on ``y`` (the pipeline's default
    demixer), each on the card's clock (events between them): K3 from 16 to
    44.1 kHz, the separator, and the dialog stem's mean with K3 back; and
    the host wall of the three."""
    import torch

    from speech_diarization_tpu_torch.dsp.resample import resample_poly
    from speech_diarization_tpu_torch.pipelines.demix import EnsembleDemixer

    dmx = EnsembleDemixer()
    y = y.to(dmx.device, torch.float32).contiguous()
    dmx.separate_on_device(torch.zeros((2, 44100 * 25), device=dmx.device), 44100)
    resample_poly(resample_poly(y, SR, 44100), 44100, SR)           # warm-up
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    t0 = time.perf_counter()
    ev[0].record()
    up = resample_poly(y, SR, 44100)
    ev[1].record()
    stems = dmx.separate_on_device(up.expand(2, -1), 44100)
    ev[2].record()
    resample_poly(stems[2].mean(dim=0), 44100, SR)
    ev[3].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"resample_up_ms": ev[0].elapsed_time(ev[1]),
            "separate_span_ms": ev[1].elapsed_time(ev[2]),
            "resample_down_ms": ev[2].elapsed_time(ev[3]), "wall_s": wall,
            "samples_44k": int(up.shape[-1])}


def profile_noisy(seconds: float, smi: str, backend: str = "gtcrn") -> dict:
    """Host stages, device time by kernel and busy share of the noisy-input
    route through ``backend``, then the enhancer by part."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from speech_diarization_tpu_torch.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig, EnhanceConfig,
    )
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
    from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout
    from speech_diarization_tpu_torch.utils.logging import get_logger

    cfg = DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8),
                            embed=EmbedConfig(grid_backend="auto"),
                            enhance=EnhanceConfig(backend=backend))
    w = ROOT / "weights"
    pipe = DiarizationPipeline(
        cfg, encoder=load_speaker_encoder(w / "ecapa_robust_stream.npz",
                                          dtype=torch.bfloat16),
        vad=load_vad(w / "vad_conv_mc.npz"))
    wave, _ = make_conversation_heldout(np.random.default_rng(0), seconds,
                                        n_speakers=3, sr=SR, snr_db=10.0,
                                        noise_kind="white")
    res = pipe(wave)                             # warm-up (builds kernels)
    if res.diagnostics.get("route") != "legacy":
        raise RuntimeError("the noisy file did not take the whole-file path")

    logger = get_logger("diarize")
    handler = _StageLog()
    logger.addHandler(handler)
    root = logging.getLogger("sdtpu")
    old_level = root.level
    root.setLevel(logging.INFO)
    phases = []
    for _ in range(3):
        handler.walls = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(wave)
        phases.append({"wall_s": time.perf_counter() - t0,
                       **{f"{k}_s": v for k, v in handler.walls.items()}})
    root.setLevel(old_level)
    logger.removeHandler(handler)
    best = min(phases, key=lambda p: p["wall_s"])

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = _device_kernels(prof)
    busy_us = sum(v for _, v, _ in kern)
    print(f"card: {smi}; {seconds:.0f} s file, white noise at 10 dB, config "
          f"defaults with --enhance {backend} (whole-file path)")
    print("best of 3 host stages: " + ", ".join(
        f"{k} {v:.4f}" for k, v in best.items()))
    print(f"profiled wall {wall:.4f} s; device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.2f} % of the wall)")
    print(f"{'device time (ms)':>17} {'calls':>6}  name")
    for name, v, n in kern[:24]:
        print(f"{v / 1e3:17.3f} {n:6d}  {name[:90]}")
    own = [r for r in kern if any(k in r[0] for k in PORT_KERNELS)]
    for name, v, n in own:
        if (name, v, n) not in kern[:24]:
            print(f"{v / 1e3:17.3f} {n:6d}  {name[:90]}")

    out = {"card": smi, "seconds": seconds, "noisy": True, "enhance": backend,
           "host_stages_best": best, "profiled_wall_s": wall,
           "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall,
           "top_kernels_ms": {name[:80]: v / 1e3 for name, v, _ in kern[:16]},
           "port_kernels_ms": {name[:80]: (v / 1e3, n) for name, v, n in own}}
    # the enhancer alone, on the padded waveform the whole-file path hands it
    bucket = 60 * SR
    t_pad = max(bucket, -(-len(wave) // bucket) * bucket)
    y = F.pad(torch.from_numpy(wave.astype(np.float32)), (0, t_pad - len(wave))).cuda()
    if backend != "gtcrn":
        part = (zipenhancer_by_part(y) if backend == "zipenhancer"
                else demix_by_part(y))
        print(f"{backend} on {t_pad / SR:.0f} s: " + ", ".join(
            f"{k} {v:.4f}" for k, v in part.items()))
        out[backend] = part
        print(json.dumps(out))
        return out
    g = gtcrn_by_module(pipe.enhance_fn, y)
    print(f"GTCRN on {t_pad / SR:.0f} s: {g['enhancer_ms']:.2f} ms (net "
          f"{g['net_ms']:.2f}, STFT + iSTFT + OLA {g['stft_istft_ms']:.2f}); "
          f"GRUs over time {g['time_grus_ms']:.2f}, intra GRUs over bins "
          f"{g['intra_grus_ms']:.2f}, the rest {g['not_gru_ms']:.2f}")
    for name, v in g["blocks_ms"].items():
        inner = {k: round(x, 3) for k, x in g["grus_ms"].items()
                 if k.startswith(name + ".")}
        print(f"  {name:22s} {v:9.3f} ms   GRUs {inner}")
    out["gtcrn"] = g
    print(json.dumps(out))
    return out


def profile_engine(seconds: float, smi: str) -> dict:
    """The segmentation engine at its defaults: host stages (best of 3),
    peak device memory, device time by kernel and busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from speech_diarization_tpu_torch.models.port import (
        load_segmentation, load_speaker_encoder,
    )
    from speech_diarization_tpu_torch.pipelines.segmentation import (
        make_seg_activities_fn, segmentation_diarize,
    )
    from speech_diarization_tpu_torch.train.synthetic import make_conversation
    from speech_diarization_tpu_torch.utils.device import disable_tf32
    from speech_diarization_tpu_torch.utils.logging import get_logger

    disable_tf32()
    w = ROOT / "weights"
    enc = load_speaker_encoder(w / "ecapa_robust_stream.npz",
                               dtype=torch.bfloat16).to("cuda").eval()
    fn = make_seg_activities_fn(load_segmentation(
        w / "segmentation_conv.npz").to("cuda").eval())
    wave, _ = make_conversation(np.random.default_rng(0), seconds,
                                n_speakers=3, sr=SR)

    def run():
        return segmentation_diarize(wave, SR, fn, enc.encode_batch)

    run()                                        # warm-up (builds kernels)
    logger = get_logger("segmentation")
    handler = _StageLog()
    logger.addHandler(handler)
    root = logging.getLogger("sdtpu")
    old_level = root.level
    root.setLevel(logging.INFO)
    runs = []
    for _ in range(3):
        handler.walls = {}
        torch.cuda.synchronize()
        wall = _timed(run)
        runs.append({"wall_s": wall, **handler.walls})
    root.setLevel(old_level)
    logger.removeHandler(handler)
    best = min(runs, key=lambda r: r["wall_s"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = _device_kernels(prof)
    busy_us = sum(v for _, v, _ in kern)
    print(f"card: {smi}; segmentation engine on a {seconds:.0f} s file")
    print("best of 3 host stages: " + ", ".join(
        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in best.items()))
    print(f"peak device memory {peak_gb:.3f} GB above the resident set; "
          f"profiled wall {wall:.4f} s; device busy {busy_us / 1e6:.4f} s "
          f"({100 * busy_us / 1e6 / wall:.2f} % of the wall)")
    print(f"{'device time (ms)':>17} {'calls':>6}  name")
    for name, v, n in kern[:16]:
        print(f"{v / 1e3:17.3f} {n:6d}  {name[:90]}")
    out = {"card": smi, "seconds": seconds, "engine": "segmentation_conv",
           "host_stages_best": best, "peak_gb": peak_gb, "profiled_wall_s": wall,
           "device_busy_s": busy_us / 1e6, "device_busy_share": busy_us / 1e6 / wall,
           "top_kernels_ms": {name[:80]: v / 1e3 for name, v, _ in kern[:12]}}
    print(json.dumps(out))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--overlap", default="both", choices=["off", "on", "both"])
    ap.add_argument("--noisy", action="store_true",
                    help="profile the noisy-input route instead")
    ap.add_argument("--enhance", default="gtcrn",
                    choices=["gtcrn", "zipenhancer", "demix-dialog"],
                    help="with --noisy: the enhancement backend")
    ap.add_argument("--engine", action="store_true",
                    help="profile the segmentation engine instead")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if args.noisy:
        profile_noisy(args.seconds, smi, args.enhance)
        return 0
    if args.engine:
        profile_engine(args.seconds, smi)
        return 0
    runs = {ov: profile_config(args.seconds, ov, smi)
            for ov in ((False, True) if args.overlap == "both"
                       else (args.overlap == "on",))}
    if len(runs) == 2:
        off, on = runs[False], runs[True]
        names = set(on["kernels"]) | set(off["kernels"])
        diff = sorted(((on["kernels"].get(k, (0.0, 0))[0]
                        - off["kernels"].get(k, (0.0, 0))[0],
                        on["kernels"].get(k, (0.0, 0))[1]
                        - off["kernels"].get(k, (0.0, 0))[1], k) for k in names),
                      reverse=True)
        print("what the overlap detector adds (on minus off):")
        print(f"  device busy {on['device_busy_s'] - off['device_busy_s']:+.4f} s; "
              + ", ".join(
                  f"{k} {on['host_phases_best'][k] - off['host_phases_best'][k]:+.4f}"
                  for k in ("dispatch_s", "device_wait_s", "host_tail_s", "wall_s")))
        print(f"  calls added {sum(n for _, n, _ in diff)}")
        print(f"{'device time (ms)':>17} {'calls':>6}  name")
        for v, n, name in diff[:16]:
            print(f"{v:+17.3f} {n:+6d}  {name[:90]}")
    # the host's Viterbi decode of frame reassignment with --hmm, at the
    # size a 600 s file gives it (about 6,000 windows)
    from speech_diarization_tpu_torch.ops.viterbi import (
        sticky_transition_logits, viterbi_decode,
    )

    rng = np.random.default_rng(0)
    for k in (3, 8):
        scores = rng.standard_normal((6000, k)).astype(np.float32)
        log_a = sticky_transition_logits(k)
        best = min(_timed(lambda: viterbi_decode(scores, log_a)) for _ in range(3))
        print(f"viterbi_decode [6000, {k}] on the host: {1e3 * best:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

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

    python3 scripts/torch_profile_diarize.py [--seconds 600] [--overlap off|on|both]

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
    events = prof.key_averages()

    from torch.autograd import DeviceType

    # device-side entries only (CPU ops also carry their children's device
    # time, which would count each kernel twice)
    kern = []
    for e in events:
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        v = getattr(e, "self_device_time_total", None)
        if v is None:
            v = getattr(e, "self_cuda_time_total", 0.0)
        if v and v > 0:
            kern.append((e.key, float(v), e.count))
    kern.sort(key=lambda r: -r[1])
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=600.0)
    ap.add_argument("--overlap", default="both", choices=["off", "on", "both"])
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
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

"""Phase 8 of ``chip_smoke.py`` (``parallel_phase``) on its own: on real
cards, the meshes over the machine's first cards instead of the first card
repeated, so a shard's blocks, replica and kernel launches live on their
own card and the gathers and gradients cross cards; with ``--virtual``, on
virtual meshes of the first card, as ``chip_smoke.py`` runs it (a quick way
to time the mesh steps of two trees in one call).  The dry run stays on a
virtual mesh of the first card.

    python3 scripts/torch_mesh_cards.py             # needs 4 CUDA cards
    python3 scripts/torch_mesh_cards.py --virtual   # needs 1

Builds the kernels, loads the bf16 ``ecapa_robust_stream.npz`` and
``vad_conv_mc.npz`` on the first card, runs the phase's checks (any failure
exits nonzero; the mesh steps' resume under deterministic algorithms
among them) and prints its measurements with each card's name and power
limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--virtual", action="store_true",
                    help="virtual meshes of the first card (needs one card)")
    args = ap.parse_args()
    import torch

    if torch.cuda.device_count() < (1 if args.virtual else 4):
        print("needs a CUDA card" if args.virtual else "needs 4 CUDA cards",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from speech_diarization_tpu_torch.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig, OverlapConfig,
    )
    from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
    from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
    from speech_diarization_tpu_torch.ops import kernels
    from speech_diarization_tpu_torch.types import SegmentArray

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = "; ".join(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines())
    print(f"cards: {smi}", flush=True)
    kernels.build()
    dev = torch.device("cuda", 0)
    w = ROOT / "weights"
    enc = load_speaker_encoder(w / "ecapa_robust_stream.npz",
                               dtype=torch.bfloat16).to(dev).eval()
    vad = load_vad(w / "vad_conv_mc.npz").to(dev).eval()

    def bench_cfg(overlap, **kw):
        return DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8),
                                 embed=EmbedConfig(grid_backend="auto"),
                                 overlap=OverlapConfig(enabled=overlap), **kw)

    def der_pct(truth, segs):
        return 100.0 * diarization_error_rate(SegmentArray(*truth), segs).der

    cards = None if args.virtual else [torch.device("cuda", i) for i in range(4)]
    out = cs.parallel_phase(dev, smi, enc, vad, bench_cfg, der_pct, cards=cards)
    print(f"encode: { {k: (v if k == 'single_ms' else v['ms']) for k, v in out['encode'].items()} }")
    print("train: " + "; ".join(
        f"{k} {v['mesh']} {v['step_ms_mesh']:.3f} ms vs {v['step_ms_single']:.3f} ms"
        for k, v in out["train"].items()))
    print(f"launches: {out['launches']}; phase {out['wall']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

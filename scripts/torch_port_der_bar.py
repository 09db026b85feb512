"""DER of the JAX reference pipeline on the bench draws, on the CPU, with
the overlap rescue off and on: the bars that ``chip_smoke.py`` holds the
PyTorch port to (this DER plus one point).

Same files and configuration as ``bench.py`` with ``SDTPU_BENCH_OVERLAP=0``
and with the overlap default (on, shipped ``segmentation_conv.npz``):
``make_conversation(np.random.default_rng(0), D, n_speakers=3)`` for D = 60
and 600 s, spectral clustering (max 8 speakers), the shipped
``vad_conv_mc.npz`` and ``ecapa_robust_stream.npz`` (bf16 trunk, as
``bench.py`` loads it).  Prints one JSON line per overlap setting.

    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py [--overlap off|on|both]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--overlap", default="both", choices=["off", "on", "both"])
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from speech_diarization_tpu.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig, OverlapConfig,
    )
    from speech_diarization_tpu.metrics.der import diarization_error_rate
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.recipes import load_speaker_encoder, load_vad
    from speech_diarization_tpu.train.synthetic import make_conversation
    from speech_diarization_tpu.types import SegmentArray

    w = ROOT / "weights"
    enc, enc_p = load_speaker_encoder(w / "ecapa_robust_stream.npz",
                                      dtype=jnp.bfloat16)
    vad, vad_p = load_vad(w / "vad_conv_mc.npz")
    for ov in ((False, True) if args.overlap == "both"
               else (args.overlap == "on",)):
        cfg = DiarizationConfig(
            cluster=ClusterConfig(method="spectral", max_speakers=8),
            embed=EmbedConfig(grid_backend="auto"),
            overlap=OverlapConfig(enabled=ov))
        pipe = DiarizationPipeline(cfg, encoder=(enc, enc_p),
                                   vad_probs_fn=jax.jit(partial(vad.probs, vad_p)))
        out = {"device": jax.devices()[0].platform, "overlap": ov}
        for dur in (60.0, 600.0):
            wave, truth = make_conversation(np.random.default_rng(0), dur,
                                            n_speakers=3, sr=16000)
            t0 = time.perf_counter()
            res = pipe((wave, 16000))
            der = diarization_error_rate(SegmentArray(*truth), res.segments).der
            out[f"der_pct_{int(dur)}s"] = round(100.0 * der, 4)
            out[f"speakers_{int(dur)}s"] = res.num_speakers
            out[f"segments_{int(dur)}s"] = len(res.segments)
            out[f"wall_s_{int(dur)}s"] = round(time.perf_counter() - t0, 2)
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

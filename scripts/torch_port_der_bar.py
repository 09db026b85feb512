"""DER of the JAX reference pipeline on the CPU: the bars that
``chip_smoke.py`` holds the PyTorch port to (this DER plus one point).

Bench draws (``--overlap``): the files and configuration of ``bench.py``
with ``SDTPU_BENCH_OVERLAP=0`` and with the overlap default (on, shipped
``segmentation_conv.npz``): ``make_conversation(np.random.default_rng(0),
D, n_speakers=3)`` for D = 60 and 600 s, spectral clustering (max 8
speakers), the shipped ``vad_conv_mc.npz`` and ``ecapa_robust_stream.npz``
(bf16 trunk, as ``bench.py`` loads it).  One JSON line per overlap setting.

Noisy draws (``--noisy``): the same configuration at the config's defaults
(overlap on, enhancement on with scope ``auto``: these files take the
whole-file path through GTCRN on ``gtcrn_mc.npz``) on
``make_conversation_heldout(np.random.default_rng(0), D, n_speakers=3,
snr_db=S, noise_kind=K)`` for (K, S, D) = (white, 10, 60 s), (white, 10,
600 s) and (babble, 15, 60 s).  The JAX pipeline gets ``(wave, 16000)``
(its whole-file path cannot read a bare array).  Its GTCRN runs one chunk a
forward (``batch_chunks=1``) instead of padding each batch to four rows
with zero rows: the rows are independent, and it keeps the CPU's memory
small.  One JSON line.

``--noisy --enhance zipenhancer`` / ``demix-dialog``: the same with that
enhancement backend (shipped ``zipenhancer_mc.npz``, or the demix ensemble's
default, ``demix_synthetic.npz``) on the draws (white, 10, 60 s) and
(babble, 15, 60 s) for ZipEnhancer, (babble, 15, 60 s) and (white, 10,
600 s) for the demixer.  ZipEnhancer runs 8 windows a batch
(``EnhanceConfig(batch_size=8)``; the rows are independent): the JAX model
costs about 2.4 s a window on the CPU, so its 600 s run (400 windows) is
left out.

    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py [--overlap off|on|both]
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --noisy [--seconds 60]
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --noisy --enhance zipenhancer
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
    ap.add_argument("--noisy", action="store_true",
                    help="the noisy draws instead of the bench draws")
    ap.add_argument("--seconds", type=float, default=None,
                    help="with --noisy: only the draws of this length")
    ap.add_argument("--enhance", default="gtcrn",
                    choices=["gtcrn", "zipenhancer", "demix-dialog"],
                    help="with --noisy: the enhancement backend")
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
    if args.noisy:
        from speech_diarization_tpu.config import EnhanceConfig
        from speech_diarization_tpu.pipelines.enhance import make_enhance_fn
        from speech_diarization_tpu.train.heldout import make_conversation_heldout

        cfg = DiarizationConfig(
            cluster=ClusterConfig(method="spectral", max_speakers=8),
            embed=EmbedConfig(grid_backend="auto"),
            enhance=EnhanceConfig(backend=args.enhance, batch_size=8))
        enhance_fn = None     # the pipeline's own, from the config
        if args.enhance == "gtcrn":
            enhance_fn = make_enhance_fn("gtcrn", chunk_s=cfg.enhance.chunk_s,
                                         overlap_s=cfg.enhance.overlap_s,
                                         batch_chunks=1)
        pipe = DiarizationPipeline(
            cfg, encoder=(enc, enc_p),
            vad_probs_fn=jax.jit(partial(vad.probs, vad_p)),
            enhance_fn=enhance_fn)
        out = {"device": jax.devices()[0].platform, "noisy": True,
               "enhance": args.enhance}
        draws = {"gtcrn": (("white", 10.0, 60.0), ("white", 10.0, 600.0),
                           ("babble", 15.0, 60.0)),
                 "zipenhancer": (("white", 10.0, 60.0), ("babble", 15.0, 60.0)),
                 "demix-dialog": (("babble", 15.0, 60.0), ("white", 10.0, 600.0))}
        for kind, snr, dur in draws[args.enhance]:
            if args.seconds is not None and dur != args.seconds:
                continue
            wave, truth = make_conversation_heldout(
                np.random.default_rng(0), dur, n_speakers=3, sr=16000,
                snr_db=snr, noise_kind=kind)
            t0 = time.perf_counter()
            res = pipe((wave, 16000))
            der = diarization_error_rate(SegmentArray(*truth), res.segments).der
            tag = f"{kind}{int(snr)}_{int(dur)}s"
            out[f"der_pct_{tag}"] = round(100.0 * der, 4)
            out[f"speakers_{tag}"] = res.num_speakers
            out[f"segments_{tag}"] = len(res.segments)
            out[f"snr_db_{tag}"] = round(pipe._last_snr_db, 4)
            out[f"floor_hf_{tag}"] = round(pipe._last_floor_hf_frac, 4)
            out[f"wall_s_{tag}"] = round(time.perf_counter() - t0, 2)
            print(json.dumps(out), flush=True)
        return
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

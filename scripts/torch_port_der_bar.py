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

``--encoders``: the bench configuration (overlap on) on the 60 s bench
draw with the other shipped encoders and options, each loaded as
``bench.py`` loads its encoder (bf16 trunk): ``ecapa_synthetic_full_stream
.npz`` (streamed; attention width 128, 80 mels), ``ecapa_proto_small.npz``
(streamed; width 32), ``ecapa_synthetic.npz`` (not streaming-trained: the
windowed grid) with the GRU VAD (``vad_synthetic.npz``) and with the energy
VAD, and the default encoder with ``ClusterConfig(method='ahc')`` and
``'hdbscan'``, and the full-width streaming encoder on the windowed grid
(``EmbedConfig(grid_backend='windowed')``: the grid's log-mel at 80 mels).
Then the encoders that ship no checkpoint, at their published widths on
the seed-0 draw of ``speech_diarization_tpu_torch.models.registry.
seeded_state_dict`` (the weights ``chip_smoke.py`` phase 4k writes and
the port loads), each through the JAX package's own loader: ERes2NetV2,
CAM++ and the SpeechBrain-format ECAPA (the default ``EcapaTdnn``), all on
the windowed grid, float32; their grid runs 16 windows a batch (the
windows are independent) to keep the CPU's memory small.  DER at the
metric's default collar of 0.25 s, as every bar here.  One JSON line.

``--heldout``: the port of ``scripts/eval_heldout.py``'s table: 8 domains x
3 files of 60 s (seeds 1000 + i), collar 0.25 s, DER / JER / speaker-count
accuracy per domain, in ``eval_heldout.py``'s configuration (spectral, max
8 speakers, the overlap and enhancement defaults; ``SDTPU_EVAL_OVERLAP`` /
``SDTPU_EVAL_ENHANCE`` honoured) with the bench's bf16 trunk, as
``scripts/torch_eval_heldout.py`` runs the port on the card.  ``--heldout
--cli``: file 0 of each domain at the CLI's defaults (frame reassignment
on, float32 encoder), the held-out phase of ``chip_smoke.py``.  One JSON
line each.

``--corpus``: ``bench.py``'s milestone 3 files, ``synth_audio(600, seed=40
+ i)`` for i < 6, through the JAX ``corpus_diarize`` in the bench
configuration: per-file and mean DER.  One JSON line.

``--engine``: the segmentation engine (``segmentation_diarize``) at its
defaults (``SegmentationConfig()``: 5 s chunks every 0.625 s, purity-masked
embeddings, spectral clustering on the JAX package's numpy path, ROADMAP
F2) with ``segmentation_conv.npz`` and ``ecapa_robust_stream.npz`` (bf16
trunk) on the 60 s and 600 s bench draws and on held-out overlap file 0
(seed 1000), and with ``segmentation_ow3.npz`` on the 60 s draw.  One JSON
line.

``--bucketed``: the bench configuration (overlap on) with
``EmbedConfig(mode='bucketed')`` on the 60 s bench draw (the whole-file
path: each segment's snippet through the per-utterance encoder).  One JSON
line.

``--published``: the published enhancer graphs on seeded weights (the
draws ``chip_smoke.py`` phase 4l writes), at the ``--noisy``
configuration: ``EnhanceConfig(backend='zipenhancer-ref', weights=<npz of
the seed-0 draw of seeded_state_dict>)`` on (white, 10, 60 s), and with
``SDTPU_DEMUCS_CKPTS`` naming three full-width HTDemucs packages
(``{kwargs, state}`` ``.th`` files of seeds 0, 1, 2) ``EnhanceConfig(
backend='demix-dialog')`` and the default configuration (GTCRN, whose
auto-route takes the HTDemucs demixer on a speech-shaped floor) on
(babble, 15, 60 s).  The JAX ZipEnhancerRef gets the port's exact zeros
in its input spectrum (ROADMAP F18: without them its first frame's phase
is the sign of rounding noise); its DER on the spectrum as computed is
printed beside the bar.  It runs 4 windows a batch, and the JAX demixer
one chunk a forward (the rows are independent), to keep the CPU's memory
small.  One JSON line.

``--sharded``: the corpus's sharded route (``corpus_diarize`` with
``encode_model`` / ``encode_params`` on one file, fewer files than devices)
on the eight virtual CPU devices of ``XLA_FLAGS=
--xla_force_host_platform_device_count=8`` (set here before JAX starts):
the bench configuration (overlap on) with ``ecapa_robust_stream.npz`` (bf16
trunk) as the encoder to shard and the bench's ``vad_conv_mc.npz``, on the
60 s bench draw; the grid is the windowed one (a bare ``encode_fn``), the
clustering the numpy path the port runs (ROADMAP F2).  The bar of
``chip_smoke.py`` phase 8b.  One JSON line.

``--batch``: ``run_batch`` at ``Diarizer()``'s defaults (AHC, 2-6 speakers
at cos 0.70, the default encoder in float32, the energy VAD) with each
engine on a directory of two 60 s draws (``make_conversation(
default_rng(50 + i), 60, n_speakers=3)``, written as 16-bit WAV): the RTTM
lines and DER per file.  One JSON line, also written to
``scripts/torch_port_batch_bars.json``, which ``chip_smoke.py`` reads.

    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py [--overlap off|on|both]
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --noisy [--seconds 60]
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --noisy --enhance zipenhancer
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --published
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --encoders
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --heldout [--cli]
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --corpus
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --engine | --bucketed | --batch
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --sharded
    JAX_PLATFORMS=cpu python scripts/torch_port_der_bar.py --tools

``--tools``: the JAX CPU bars of the evaluation and calibration tools: each
JAX script of :data:`TOOL_COMMANDS` at its default table (the weights a
script requires: the shipped conv VAD for ``eval_vad.py``, the shipped
GTCRN and ZipEnhancer for ``eval_enhancer.py``; ``calibrate_bisect.py`` also
with the conv VAD), each in its own process on the CPU.  The port's
``scripts/torch_<name>.py`` on the card with the same arguments is held to
it.  One JSON line per run (its argv, seconds, and its standard output's
last lines).
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


# the JAX scripts' default tables (``--tools``); the port's scripts take the
# same arguments
TOOL_COMMANDS = {
    "eval_rttm": ("eval_rttm", []),
    "eval_synthetic": ("eval_synthetic", []),
    "eval_tail": ("eval_tail", []),
    "calibrate_bisect": ("calibrate_bisect", []),
    "calibrate_bisect_conv_vad": ("calibrate_bisect",
                                  ["--vad", "weights/vad_conv_mc.npz"]),
    "eval_vad": ("eval_vad", ["--weights", "weights/vad_conv_mc.npz"]),
    "eval_overlap_det": ("eval_overlap_det", []),
    "eval_segmentation": ("eval_segmentation", []),
    "probe_encoder": ("probe_encoder", []),
    "eval_enhancer_gtcrn": ("eval_enhancer", ["--backend", "gtcrn", "--weights",
                                              "weights/gtcrn_mc.npz"]),
    "eval_enhancer_zipenhancer": ("eval_enhancer",
                                  ["--weights", "weights/zipenhancer_mc.npz"]),
    "eval_grid_backends": ("eval_grid_backends", []),
}


def tools_bar() -> None:
    """Each JAX tool at its default table on the CPU, in its own process."""
    import os
    import subprocess

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for name, (script, extra) in TOOL_COMMANDS.items():
        # eval_grid_backends.py has no --cpu: the variable keeps it there
        argv = [sys.executable, f"scripts/{script}.py", *extra] + (
            [] if script == "eval_grid_backends" else ["--cpu"])
        t0 = time.perf_counter()
        run = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True)
        print(json.dumps({"tool": name, "argv": argv[1:], "rc": run.returncode,
                          "seconds": round(time.perf_counter() - t0, 1),
                          "stdout": run.stdout.strip().splitlines()[-30:]}),
              flush=True)


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
    ap.add_argument("--encoders", action="store_true",
                    help="the other encoders, VADs and clustering methods")
    ap.add_argument("--heldout", action="store_true",
                    help="the held-out table (eval_heldout.py's draws)")
    ap.add_argument("--cli", action="store_true",
                    help="with --heldout: file 0 per domain, CLI defaults")
    ap.add_argument("--corpus", action="store_true",
                    help="bench.py's corpus milestone files")
    ap.add_argument("--engine", action="store_true",
                    help="the segmentation engine at its defaults")
    ap.add_argument("--bucketed", action="store_true",
                    help="the bench configuration with bucketed embeddings")
    ap.add_argument("--batch", action="store_true",
                    help="run_batch at Diarizer()'s defaults, both engines")
    ap.add_argument("--published", action="store_true",
                    help="the published enhancer graphs on seeded weights")
    ap.add_argument("--sharded", action="store_true",
                    help="the corpus's sharded route on 8 virtual CPU devices")
    ap.add_argument("--tools", action="store_true",
                    help="the JAX evaluation tools at their default tables")
    args = ap.parse_args()
    if args.tools:
        return tools_bar()
    if args.sharded:
        import os

        flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
                 if "xla_force_host_platform_device_count" not in f]
        os.environ["XLA_FLAGS"] = " ".join(
            flags + ["--xla_force_host_platform_device_count=8"])

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
    if args.encoders:
        return encoders_bar(w, (enc, enc_p), jax.jit(partial(vad.probs, vad_p)))
    if args.heldout:
        return heldout_bar(w, args.cli)
    if args.corpus:
        return corpus_bar((enc, enc_p), jax.jit(partial(vad.probs, vad_p)))
    if args.engine:
        return engine_bar(w, jax.jit(partial(enc.encode_batch, enc_p)))
    if args.bucketed:
        return bucketed_bar((enc, enc_p), jax.jit(partial(vad.probs, vad_p)))
    if args.batch:
        return batch_bar()
    if args.published:
        return published_bar((enc, enc_p), jax.jit(partial(vad.probs, vad_p)))
    if args.sharded:
        return sharded_bar((enc, enc_p), jax.jit(partial(vad.probs, vad_p)))
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


def _der(truth, segs, collar_s: float = 0.25):
    """DER of ``segs`` against the draw's truth, at the metric's default
    collar of 0.25 s, as ``bench.py`` and ``chip_smoke.py`` score."""
    from speech_diarization_tpu.metrics.der import diarization_error_rate
    from speech_diarization_tpu.types import SegmentArray

    return diarization_error_rate(SegmentArray(*truth), segs, collar_s=collar_s)


def encoders_bar(w, default_enc, conv_vad) -> None:
    """The bench configuration on the 60 s bench draw with each of the other
    encoders, VADs and clustering methods of ``chip_smoke.py``'s pipeline
    phase."""
    import jax
    import jax.numpy as jnp

    from speech_diarization_tpu.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig,
    )
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.recipes import load_speaker_encoder, load_vad
    from speech_diarization_tpu.train.synthetic import make_conversation

    def enc(name):
        return load_speaker_encoder(w / name, dtype=jnp.bfloat16)

    gru, gru_p = load_vad(w / "vad_synthetic.npz")
    full = enc("ecapa_synthetic_full_stream.npz")
    seeded = seeded_encoders()
    cases = {
        # tag: (encoder, VAD, clustering method, grid backend)
        **{tag: (pair, conv_vad, "spectral", "auto") for tag, pair in seeded.items()},
        "full_stream": (full, conv_vad, "spectral", "auto"),
        "full_stream_windowed": (full, conv_vad, "spectral", "windowed"),
        "proto_small": (enc("ecapa_proto_small.npz"), conv_vad, "spectral", "auto"),
        "windowed_gru": (enc("ecapa_synthetic.npz"),
                         jax.jit(partial(gru.probs, gru_p)), "spectral", "auto"),
        "windowed_energy": (enc("ecapa_synthetic.npz"), None, "spectral", "auto"),
        "ahc": (default_enc, conv_vad, "ahc", "auto"),
        "hdbscan": (default_enc, conv_vad, "hdbscan", "auto"),
    }
    wave, truth = make_conversation(np.random.default_rng(0), 60.0,
                                    n_speakers=3, sr=16000)
    out = {"device": jax.devices()[0].platform, "draw": "bench 60 s"}
    for tag, (encoder, vad_fn, method, grid) in cases.items():
        small = {"batch_size": 16, "max_batch_size": 16} if tag in seeded else {}
        cfg = DiarizationConfig(
            cluster=ClusterConfig(method=method, max_speakers=8),
            embed=EmbedConfig(grid_backend=grid, **small))
        pipe = DiarizationPipeline(cfg, encoder=encoder, vad_probs_fn=vad_fn)
        t0 = time.perf_counter()
        res = pipe((wave, 16000))
        out[f"der_pct_{tag}"] = round(100.0 * _der(truth, res.segments).der, 4)
        out[f"speakers_{tag}"] = res.num_speakers
        out[f"segments_{tag}"] = len(res.segments)
        out[f"wall_s_{tag}"] = round(time.perf_counter() - t0, 2)
        print(json.dumps(out), flush=True)


def seeded_encoders() -> dict:
    """The JAX ``(model, params)`` of each encoder that ships no checkpoint,
    on the seed-0 numpy draw, loaded by the JAX loaders."""
    from speech_diarization_tpu.models.campp import CamPlusPlusModel, load_campp
    from speech_diarization_tpu.models.ecapa import EcapaModel
    from speech_diarization_tpu.models.eres2netv2 import (
        ERes2NetV2Model, load_eres2netv2,
    )
    from speech_diarization_tpu.models.port_ecapa import (
        ecapa_torch_manifest, load_ecapa_speechbrain,
    )
    from speech_diarization_tpu_torch.models.registry import seeded_state_dict

    eres, campp, ecapa = ERes2NetV2Model(), CamPlusPlusModel(), EcapaModel()
    return {
        "eres2netv2": (eres, load_eres2netv2(
            seeded_state_dict(eres.net.manifest(), 0), eres.net)),
        "campp": (campp, load_campp(
            seeded_state_dict(campp.net.manifest(), 0), campp.net)),
        "ecapa_speechbrain": (ecapa, load_ecapa_speechbrain(
            seeded_state_dict(ecapa_torch_manifest(ecapa.net), 0), ecapa.net)),
    }


def exact_spectrum(y, n_fft, hop, window=None):
    """The JAX STFT with the port's exact zeros (``models/zipenhancer_ref.
    exact_zero_imag``): +0 imaginary parts on the DC and Nyquist bins and
    on the first frame."""
    import jax.numpy as jnp

    from speech_diarization_tpu.dsp.stft import stft_ri

    spec = stft_ri(y, n_fft, hop, window=window)
    keep = np.ones(spec.shape[-3:-1], bool)
    keep[0] = keep[-1] = False
    keep[:, 0] = False
    return spec.at[..., 1].set(jnp.where(jnp.asarray(keep), spec[..., 1], 0.0))


def write_seeded_published(tmp: Path) -> tuple[Path, list[Path]]:
    """The seeded draws of the published graphs: ZipEnhancerRef's (seed 0)
    as an ``.npz`` and three HTDemucs packages (seeds 0, 1, 2) as ``.th``."""
    import torch

    from speech_diarization_tpu_torch.models.demucs_ref import HTDemucsRef
    from speech_diarization_tpu_torch.models.registry import seeded_state_dict
    from speech_diarization_tpu_torch.models.zipenhancer_ref import ZipEnhancerRef

    zip_npz = tmp / "zipenhancer_ref_seed0.npz"
    np.savez(zip_npz, **seeded_state_dict(ZipEnhancerRef().manifest(), 0))
    ths = []
    man = HTDemucsRef().manifest()
    for seed in range(3):
        ths.append(tmp / f"htdemucs_seed{seed}.th")
        torch.save({"kwargs": {"sources": ["music", "effect", "dialog"]},
                    "state": {k: torch.from_numpy(v) for k, v in
                              seeded_state_dict(man, seed).items()}}, ths[-1])
    return zip_npz, ths


def published_bar(encoder, vad_fn) -> None:
    import os
    import tempfile

    import jax
    import jax.numpy as jnp

    import speech_diarization_tpu.models.zipenhancer_ref as jzr
    import speech_diarization_tpu.pipelines.demix as jdemix
    from speech_diarization_tpu.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig, EnhanceConfig,
    )
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.pipelines.enhance import make_enhance_fn
    from speech_diarization_tpu.train.heldout import make_conversation_heldout

    init = jdemix.EnsembleDemixer.__init__

    def one_chunk_a_forward(self, *a, **kw):
        init(self, *a, **kw)
        fwd = self._fwd
        self._fwd = lambda p, x: jnp.concatenate(
            [fwd(p, x[i:i + 1]) for i in range(x.shape[0])])

    jdemix.EnsembleDemixer.__init__ = one_chunk_a_forward
    computed = jzr.stft_ri
    out = {"device": jax.devices()[0].platform, "published": True}
    with tempfile.TemporaryDirectory() as tmp:
        zip_npz, ths = write_seeded_published(Path(tmp))
        runs = [("zipenhancer-ref", "white", 10.0, True),
                ("zipenhancer-ref_computed_spectrum", "white", 10.0, False),
                ("demix-dialog", "babble", 15.0, True),
                ("auto", "babble", 15.0, True)]
        for tag, kind, snr, exact in runs:
            backend = tag.split("_")[0]
            jzr.stft_ri = exact_spectrum if exact else computed
            cfg = DiarizationConfig(
                cluster=ClusterConfig(method="spectral", max_speakers=8),
                embed=EmbedConfig(grid_backend="auto"),
                enhance=EnhanceConfig(
                    backend="gtcrn" if backend == "auto" else backend, batch_size=4,
                    weights=str(zip_npz) if backend == "zipenhancer-ref" else None))
            enhance_fn = None
            if backend == "auto":
                enhance_fn = make_enhance_fn("gtcrn", chunk_s=cfg.enhance.chunk_s,
                                             overlap_s=cfg.enhance.overlap_s,
                                             batch_chunks=1)
            if backend != "zipenhancer-ref":
                os.environ["SDTPU_DEMUCS_CKPTS"] = ":".join(map(str, ths))
            try:
                pipe = DiarizationPipeline(cfg, encoder=encoder, vad_probs_fn=vad_fn,
                                           enhance_fn=enhance_fn)
                wave, truth = make_conversation_heldout(
                    np.random.default_rng(0), 60.0, n_speakers=3, sr=16000,
                    snr_db=snr, noise_kind=kind)
                t0 = time.perf_counter()
                res = pipe((wave, 16000))
            finally:
                os.environ.pop("SDTPU_DEMUCS_CKPTS", None)
            key = f"{tag}_{kind}{int(snr)}_60s"
            out[f"der_pct_{key}"] = round(100.0 * _der(truth, res.segments).der, 4)
            out[f"speakers_{key}"] = res.num_speakers
            out[f"segments_{key}"] = len(res.segments)
            out[f"wall_s_{key}"] = round(time.perf_counter() - t0, 2)
            print(json.dumps(out), flush=True)


def heldout_bar(w, cli: bool) -> None:
    """The JAX pipeline on ``eval_heldout.py``'s draws: per domain DER, JER
    and speaker-count accuracy (collar 0.25 s), or with ``cli`` file 0 of
    each domain at the CLI's defaults."""
    import argparse
    import os

    import jax
    import jax.numpy as jnp

    from speech_diarization_tpu.cli import (
        _add_common_config_args, build_config, build_pipeline_kwargs,
    )
    from speech_diarization_tpu.config import (
        ClusterConfig, DiarizationConfig, EnhanceConfig, OverlapConfig,
    )
    from speech_diarization_tpu.metrics.der import jaccard_error_rate
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.recipes import load_speaker_encoder, load_vad
    from speech_diarization_tpu.types import SegmentArray

    sys.path.insert(0, str(ROOT / "scripts"))
    from eval_heldout import DOMAINS, make_file

    if cli:
        p = argparse.ArgumentParser()
        _add_common_config_args(p)
        args = p.parse_args(["--cpu"])
        pipe = DiarizationPipeline(build_config(args), **build_pipeline_kwargs(args))
        n_files = 1
    else:
        enh = os.environ.get("SDTPU_EVAL_ENHANCE")
        ov = os.environ.get("SDTPU_EVAL_OVERLAP")
        cfg = DiarizationConfig(
            cluster=ClusterConfig(method="spectral", max_speakers=8),
            overlap=OverlapConfig(**({} if ov is None else {"enabled": ov == "1"})),
            enhance=EnhanceConfig(enabled=enh != "off",
                                  backend=enh if enh not in (None, "off") else "gtcrn"))
        vad, vad_p = load_vad(w / "vad_conv_mc.npz")
        pipe = DiarizationPipeline(
            cfg, encoder=load_speaker_encoder(w / "ecapa_robust_stream.npz",
                                              dtype=jnp.bfloat16),
            vad_probs_fn=jax.jit(partial(vad.probs, vad_p)))
        n_files = 3
    out = {"device": jax.devices()[0].platform,
           "surface": "cli" if cli else "eval_heldout", "domains": {}}
    for domain in DOMAINS:
        ders, jers, ok, files = [], [], [], []
        for i in range(n_files):
            wave, truth = make_file(domain, i, 60.0, 3, 16000)
            res = pipe((wave, 16000))
            d = _der(truth, res.segments, collar_s=0.25).der
            ders.append(d)
            jers.append(jaccard_error_rate(SegmentArray(*truth), res.segments,
                                           collar_s=0.25))
            ok.append(res.num_speakers == len(np.unique(truth[2])))
            files.append(round(100.0 * d, 4))
        out["domains"][domain] = {
            "der_pct": round(100.0 * float(np.mean(ders)), 4),
            "jer_pct": round(100.0 * float(np.mean(jers)), 4),
            "spk_count_acc": round(float(np.mean(ok)), 4), "der_pct_files": files}
        print(json.dumps(out), flush=True)


def corpus_bar(encoder, vad_fn) -> None:
    """``bench.py``'s milestone 3 draws through the JAX corpus worker."""
    import jax

    from speech_diarization_tpu.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig,
    )
    from speech_diarization_tpu.pipelines.corpus import corpus_diarize
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.synthetic import make_conversation

    cfg = DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8),
                            embed=EmbedConfig(grid_backend="auto"))
    pipe = DiarizationPipeline(cfg, encoder=encoder, vad_probs_fn=vad_fn)
    pairs = [make_conversation(np.random.default_rng(40 + i), 600.0,
                               n_speakers=3, sr=16000) for i in range(6)]
    t0 = time.perf_counter()
    report = corpus_diarize([(wv, 16000) for wv, _ in pairs], cfg,
                            pipeline_factory=lambda: pipe, keep_results=True)
    ders = {f["index"]: round(100.0 * _der(pairs[f["index"]][1],
                                           f["result"].segments).der, 4)
            for f in report.files}
    print(json.dumps({"device": jax.devices()[0].platform, "corpus": "6 x 600 s",
                      "der_pct_files": [ders.get(i) for i in range(6)],
                      "der_pct_mean": round(float(np.mean(list(ders.values()))), 4),
                      "errors": report.errors,
                      "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)


def sharded_bar(encoder, vad_fn) -> None:
    """The JAX corpus's sharded route on one 60 s bench draw over the eight
    virtual CPU devices."""
    import jax

    from speech_diarization_tpu.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig,
    )
    from speech_diarization_tpu.pipelines.corpus import corpus_diarize
    from speech_diarization_tpu.train.synthetic import make_conversation

    _numpy_spectral()
    cfg = DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8),
                            embed=EmbedConfig(grid_backend="auto"))
    wave, truth = make_conversation(np.random.default_rng(0), 60.0, n_speakers=3,
                                    sr=16000)
    t0 = time.perf_counter()
    report = corpus_diarize([(wave, 16000)], cfg, encode_model=encoder[0],
                            encode_params=encoder[1], keep_results=True,
                            vad_probs_fn=vad_fn)
    if report.errors or report.files[0]["device"] != "sharded[8]":
        raise RuntimeError(f"not the sharded route: {report.files} {report.errors}")
    res = report.files[0]["result"]
    print(json.dumps({"device": jax.devices()[0].platform,
                      "n_devices": jax.device_count(), "route": "sharded[8]",
                      "der_pct_bench_60s": round(100.0 * _der(truth, res.segments).der, 4),
                      "segments": len(res.segments), "speakers": res.num_speakers,
                      "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)


def _numpy_spectral() -> None:
    """Spectral clustering on the JAX package's numpy path (ROADMAP F2), the
    path the port implements."""
    import speech_diarization_tpu.cluster.spectral as jspectral

    jspectral._device_capable = lambda: False


def engine_bar(w, encode_fn) -> None:
    """The segmentation engine at its defaults on the bench draws and the
    held-out overlap file."""
    import jax

    from speech_diarization_tpu.pipelines.segmentation import (
        make_seg_activities_fn, segmentation_diarize,
    )
    from speech_diarization_tpu.train.recipes import load_segmentation
    from speech_diarization_tpu.train.synthetic import make_conversation

    sys.path.insert(0, str(ROOT / "scripts"))
    from eval_heldout import make_file

    _numpy_spectral()
    fns = {n: make_seg_activities_fn(*load_segmentation(w / f"segmentation_{n}.npz"))
           for n in ("conv", "ow3")}
    draws = {f"bench_{d}s": make_conversation(np.random.default_rng(0), float(d),
                                              n_speakers=3, sr=16000)
             for d in (60, 600)}
    draws["heldout_overlap_0"] = make_file("heldout-overlap", 0, 60.0, 3, 16000)
    cases = [("conv", tag) for tag in draws] + [("ow3", "bench_60s")]
    out = {"device": jax.devices()[0].platform, "engine": "segmentation"}
    for net, tag in cases:
        wave, truth = draws[tag]
        t0 = time.perf_counter()
        segs = segmentation_diarize(wave, 16000, fns[net], encode_fn)
        key = f"{net}_{tag}"
        out[f"der_pct_{key}"] = round(100.0 * _der(truth, segs).der, 4)
        out[f"segments_{key}"] = len(segs)
        out[f"speakers_{key}"] = len({int(k) for k in segs.spks})
        out[f"wall_s_{key}"] = round(time.perf_counter() - t0, 2)
        print(json.dumps(out), flush=True)


def bucketed_bar(encoder, vad_fn) -> None:
    """The bench configuration with ``EmbedConfig(mode='bucketed')`` on the
    60 s bench draw."""
    import jax

    from speech_diarization_tpu.config import (
        ClusterConfig, DiarizationConfig, EmbedConfig,
    )
    from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline
    from speech_diarization_tpu.train.synthetic import make_conversation

    cfg = DiarizationConfig(cluster=ClusterConfig(method="spectral", max_speakers=8),
                            embed=EmbedConfig(grid_backend="auto", mode="bucketed"))
    pipe = DiarizationPipeline(cfg, encoder=encoder, vad_probs_fn=vad_fn)
    wave, truth = make_conversation(np.random.default_rng(0), 60.0, n_speakers=3,
                                    sr=16000)
    t0 = time.perf_counter()
    res = pipe((wave, 16000))
    print(json.dumps({"device": jax.devices()[0].platform, "embed": "bucketed",
                      "der_pct_bench_60s": round(100.0 * _der(truth, res.segments).der, 4),
                      "segments": len(res.segments), "speakers": res.num_speakers,
                      "wall_s": round(time.perf_counter() - t0, 2)}), flush=True)


def read_rttm(path) -> list[list]:
    """[start, duration, speaker] of each SPEAKER line."""
    rows = []
    for line in Path(path).read_text().splitlines():
        f = line.split()
        rows.append([float(f[3]), float(f[4]), f[7]])
    return rows


def batch_bar() -> None:
    """``run_batch`` at ``Diarizer()``'s defaults with each engine on two
    60 s WAVs."""
    import tempfile

    import jax

    from speech_diarization_tpu.io.audio import write_wav
    from speech_diarization_tpu.pipelines.baseline import run_batch
    from speech_diarization_tpu.train.synthetic import make_conversation
    from speech_diarization_tpu.types import SegmentArray

    _numpy_spectral()
    draws = [make_conversation(np.random.default_rng(50 + i), 60.0, n_speakers=3,
                               sr=16000) for i in range(2)]
    out = {"device": jax.devices()[0].platform, "batch": "Diarizer() defaults",
           "draws": "make_conversation(default_rng(50 + i), 60.0, n_speakers=3)",
           "engines": {}}
    for engine in ("flagship", "segmentation"):
        with tempfile.TemporaryDirectory() as tmp:
            for i, (wave, _) in enumerate(draws):
                write_wav(Path(tmp) / f"draw{i}.wav", wave, 16000)
            t0 = time.perf_counter()
            done = run_batch(tmp, engine=engine)
            files = {}
            for i, (_, truth) in enumerate(draws):
                rows = read_rttm(Path(tmp) / f"draw{i}.rttm")
                names = sorted({r[2] for r in rows})
                segs = SegmentArray(np.array([r[0] for r in rows]),
                                    np.array([r[0] + r[1] for r in rows]),
                                    np.array([names.index(r[2]) for r in rows]))
                files[f"draw{i}"] = {"rttm": rows,
                                     "der_pct": round(100.0 * _der(truth, segs).der, 4)}
            out["engines"][engine] = {"files": files, "processed": len(done),
                                      "wall_s": round(time.perf_counter() - t0, 2)}
    (ROOT / "scripts" / "torch_port_batch_bars.json").write_text(
        json.dumps(out, indent=1) + "\n")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

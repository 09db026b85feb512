"""Command-line entry point of the PyTorch port: ``sdtpu-torch``.

    python -m speech_diarization_tpu_torch.cli diarize x.wav [--cpu]
    python -m speech_diarization_tpu_torch.cli batch <root> [--engine flagship|segmentation]
    python -m speech_diarization_tpu_torch.cli diag x.wav [--out-dir out]
    python -m speech_diarization_tpu_torch.cli enhance <root> [--backend gtcrn|zipenhancer|zipenhancer-ref]
    python -m speech_diarization_tpu_torch.cli demix <root> [--output out]

Runs on the card unless ``--cpu`` is given.  ``diarize`` runs at the
defaults of the JAX package's CLI: overlap rescue on (the segmentation
model runs inside the per-chunk device program), frame reassignment on,
spectral clustering, the shipped conv VAD, and the GTCRN denoiser engaged
on files whose estimated SNR is under 25 dB (they take the whole-file
path).  ``--cluster-method`` (spectral, ahc, hdbscan, hdbscan2) with
``--cos-threshold``, ``--vad-backend`` (auto: the first shipped neural VAD
of the conv TCNs and the GRU net, else the energy VAD; energy; neural) with
``--vad-weights``, ``--encoder`` (ecapa, eres2netv2, campp) with
``--encoder-weights`` (an ECAPA ``.npz`` or SpeechBrain
``embedding_model.ckpt``, a 3D-Speaker ``.pt`` / ``.ckpt`` or ``.onnx``;
every encoder but a streaming-trained ECAPA runs the windowed grid),
``--no-overlap``, ``--no-reseg``, ``--hmm``, ``--enhance`` (gtcrn,
zipenhancer, demix-dialog or off), ``--enhance-scope`` and
``--enhance-weights`` are options.  Writes RTTM, JSON, SRT and CSV.
``batch`` diarizes every audio file under a directory (``--engine
segmentation``: the chunk-local speaker-activity engine) and writes an RTTM
beside each and per-speaker stems under ``<stem>-speakers/``; a file whose
RTTM exists is skipped.  ``diag`` runs the diagnostic pipeline (whitening,
HDBSCAN by default, AS-Norm, Viterbi) and writes JSON/SRT/CSV and the
similarity plots (matplotlib).  Both take ``diarize``'s options.
``enhance`` writes a ``<root>-enhanced`` tree of denoised 16 kHz WAVs
(files already there are skipped); ``demix`` writes
``<output>/{music,effect,dialog}/`` stereo 44.1 kHz stems.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _add_common_config_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", type=str, default=None,
                   help="JSON file hydrating the full DiarizationConfig")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--target-lufs", type=float, default=-18.0)
    p.add_argument("--no-loudness-norm", action="store_true")
    p.add_argument("--vad-on", type=float, default=0.6)
    p.add_argument("--vad-off", type=float, default=0.4)
    p.add_argument("--min-speech-ms", type=float, default=250.0)
    p.add_argument("--min-silence-ms", type=float, default=100.0)
    p.add_argument("--speech-pad-ms", type=float, default=40.0)
    p.add_argument("--scd-threshold", type=float, default=1.0)
    p.add_argument("--no-scd", action="store_true")
    p.add_argument("--cluster-method", default="spectral",
                   choices=["spectral", "ahc", "hdbscan", "hdbscan2"])
    p.add_argument("--cos-threshold", type=float, default=0.70,
                   help="AHC cut / HDBSCAN centroid-merge cosine threshold")
    p.add_argument("--min-speakers", type=int, default=1)
    p.add_argument("--max-speakers", type=int, default=8)
    p.add_argument("--no-reseg", action="store_true",
                   help="frame reassignment off (default: on)")
    p.add_argument("--hmm", action="store_true",
                   help="sticky-HMM smoothing of the reassigned labels")
    p.add_argument("--merge-gap-s", type=float, default=0.5)
    p.add_argument("--merge-max-turn-s", type=float, default=30.0)
    p.add_argument("--merge-min-cos", type=float, default=0.80)
    p.add_argument("--enhance", default=None,
                   choices=["gtcrn", "zipenhancer", "demix-dialog", "off"],
                   help="denoise front-end before diarization; default is "
                        "gtcrn with scope 'auto' (engages only on noisy "
                        "files); 'demix-dialog' runs the dialog-stem "
                        "separation front-end; 'off' disables the stage")
    p.add_argument("--enhance-scope", default="auto",
                   choices=["full", "vad", "auto"],
                   help="'vad' denoises only the VAD input (keeps speaker "
                        "cues raw); 'full' feeds the denoised file to every "
                        "stage; 'auto' engages vad-scope only when the file "
                        "measures noisy")
    p.add_argument("--enhance-weights", type=str, default=None,
                   help=".npz checkpoint override for the enhancer")
    p.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="overlap rescue: add second-speaker segments where "
                        "the segmentation model detects two or more active "
                        "speakers.  Default on (the config default); "
                        "--no-overlap disables")
    p.add_argument("--overlap-weights", type=str, default=None,
                   help="segmentation checkpoint for the overlap detector")
    p.add_argument("--encoder", default="ecapa",
                   choices=["ecapa", "eres2netv2", "campp"],
                   help="speaker encoder; eres2netv2 and campp run the "
                        "windowed grid")
    p.add_argument("--encoder-weights", type=str, default=None,
                   help="ecapa: npz checkpoint (one that is not "
                        "streaming-trained runs the windowed grid) or a "
                        "SpeechBrain embedding_model.ckpt; eres2netv2 / "
                        "campp: 3D-Speaker .pt / .ckpt or .onnx")
    p.add_argument("--vad-backend", default="auto",
                   choices=["auto", "energy", "neural"],
                   help="'auto' uses a trained neural VAD when weights are "
                        "available (shipped or --vad-weights) and falls back "
                        "to the deterministic energy VAD otherwise")
    p.add_argument("--vad-weights", type=str, default=None,
                   help="neural VAD npz checkpoint (conv TCN or GRU net)")
    p.add_argument("--bf16", action="store_true",
                   help="run the ECAPA trunk in bfloat16 (refused with the "
                        "other encoders, which run float32)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--verbose", "-v", action="store_true")


def build_config(args: argparse.Namespace):
    from .config import (
        AudioConfig, ClusterConfig, DiarizationConfig, EnhanceConfig,
        MergeConfig, OverlapConfig, ResegConfig, ScdConfig, VadConfig,
        config_from_dict,
    )

    if args.config:
        with open(args.config) as f:
            return config_from_dict(json.load(f))
    return DiarizationConfig(
        enhance=EnhanceConfig(
            enabled=args.enhance != "off",
            backend=args.enhance if args.enhance not in (None, "off") else "gtcrn",
            scope=args.enhance_scope, weights=args.enhance_weights),
        audio=AudioConfig(
            sample_rate=args.sample_rate,
            target_lufs=None if args.no_loudness_norm else args.target_lufs,
        ),
        vad=VadConfig(
            on_threshold=args.vad_on, off_threshold=args.vad_off,
            min_speech_ms=args.min_speech_ms, min_silence_ms=args.min_silence_ms,
            speech_pad_ms=args.speech_pad_ms,
        ),
        scd=ScdConfig(enabled=not args.no_scd, peak_z_threshold=args.scd_threshold),
        cluster=ClusterConfig(method=args.cluster_method,
                              cos_threshold=args.cos_threshold,
                              min_speakers=args.min_speakers,
                              max_speakers=args.max_speakers),
        reseg=ResegConfig(enabled=not args.no_reseg, hmm=args.hmm),
        merge=MergeConfig(max_gap_s=args.merge_gap_s,
                          max_turn_s=args.merge_max_turn_s,
                          min_cos=args.merge_min_cos),
        overlap=OverlapConfig(
            # tri-state: None keeps the config default (on)
            **({} if args.overlap is None else {"enabled": args.overlap}),
            weights=args.overlap_weights),
    )


def build_pipeline_kwargs(args: argparse.Namespace) -> dict:
    """The encoder and the VAD, resolved as the JAX CLI resolves them.
    The encoder comes from the registry (``models.registry.
    make_encoder_model``): ``--encoder-weights`` in any format it reads, or
    the shipped ECAPA, or random weights with a warning.  ``--vad-backend
    auto`` / ``neural``: ``--vad-weights`` or the first
    shipped of ``VAD_PREFERENCE``; with none, ``auto`` leaves the pipeline's
    energy VAD and ``neural`` runs the GRU net on random weights (with a
    warning).  ``energy``: the pipeline's energy VAD."""
    import torch

    from .models.port import load_vad
    from .models.registry import make_encoder_model
    from .utils.weights import VAD_PREFERENCE, prefer_weights

    if args.bf16 and args.encoder != "ecapa":
        raise SystemExit(f"--bf16 runs the ECAPA trunk in bfloat16; --encoder "
                         f"{args.encoder} runs float32 only, as in the JAX "
                         "package: drop --bf16")
    encoder = make_encoder_model(args.encoder, weights=args.encoder_weights,
                                 sample_rate=args.sample_rate,
                                 dtype=torch.bfloat16 if args.bf16 else None)
    kwargs = {"encoder": encoder, "device": "cpu" if args.cpu else None}
    if args.vad_backend in ("neural", "auto"):
        vad_w = args.vad_weights or prefer_weights(VAD_PREFERENCE)
        if vad_w is not None:
            kwargs["vad"] = load_vad(vad_w)
        elif args.vad_backend == "neural":
            from .models.vad import VadModel, VadNet
            from .utils.logging import get_logger

            get_logger("cli").warning(
                "--vad-backend neural but no weights found; RANDOM VAD params "
                "(results will be meaningless: pass --vad-weights)")
            net, g = VadNet(), torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in net.parameters():
                    p.copy_(torch.randn(p.shape, generator=g) * p.shape[-1] ** -0.5)
            kwargs["vad"] = VadModel(net)
        if "vad" in kwargs:
            kwargs["vad"].sample_rate = args.sample_rate
    return kwargs


def cmd_diarize(args) -> int:
    from .io.writers import relabel_speakers, save_csv, save_json, save_srt, write_rttm
    from .pipelines.diarize import DiarizationPipeline

    cfg = build_config(args)
    pipe = DiarizationPipeline(cfg, **build_pipeline_kwargs(args))
    result = pipe(args.audio)
    segs = result.segments

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    stem = Path(args.audio).stem
    fmts = {"rttm", "json", "srt", "csv"} if args.format == "all" else {args.format}
    if "rttm" in fmts:
        write_rttm(out_dir / f"{stem}.rttm", segs, uri=stem)
    if "json" in fmts:
        save_json(out_dir / f"{stem}.json", segs)
    if "srt" in fmts:
        save_srt(out_dir / f"{stem}.srt", segs)
    if "csv" in fmts:
        save_csv(out_dir / f"{stem}.csv", segs)

    print(f"segments: {len(segs)}; speakers: {result.num_speakers}")
    for i, seg in enumerate(relabel_speakers(segs)[:20], 1):
        print(f"{i:02d}  {seg['start']:.2f}-{seg['end']:.2f}  {seg['speaker']}")
    return 0


def cmd_batch(args) -> int:
    from .pipelines.baseline import run_batch

    cfg = build_config(args)
    done = run_batch(args.root, cfg, with_rttm=True, engine=args.engine,
                     **build_pipeline_kwargs(args))
    print(f"processed {len(done)} files")
    return 0


def cmd_diag(args) -> int:
    from .pipelines.diagnostic import diagnose

    cfg = build_config(args)
    report = diagnose(args.audio, cfg, out_dir=args.out_dir,
                      cluster_method=args.cluster_method,
                      **build_pipeline_kwargs(args))
    stats = report.similarity_stats()
    print(f"segments: {len(report.segments)}")
    print(f"adjacent cos   mu={stats['adjacent_mean']:.3f} sigma={stats['adjacent_std']:.3f}")
    print(f"non-adj  cos   mu={stats['nonadjacent_mean']:.3f} sigma={stats['nonadjacent_std']:.3f}")
    print(report.tuning_hint())
    return 0


def cmd_enhance(args) -> int:
    """``--weights``: an ``.npz`` for every backend; the GTCRN DNS3 ``.tar``
    with ``--backend gtcrn``; a ModelScope state_dict with ``--backend
    zipenhancer-ref``.  Torch checkpoints are ported to a flat mapping of
    arrays, which the enhancer loads as it loads an ``.npz``'s."""
    from .pipelines.enhance import enhance_batch

    weights = args.weights
    if weights and not str(weights).endswith(".npz"):
        if args.backend == "gtcrn":
            from .models.port import load_gtcrn_checkpoint

            weights = load_gtcrn_checkpoint(weights).state_dict()
        elif args.backend == "zipenhancer-ref":
            from .models.port_zipenhancer import load_zipenhancer_modelscope

            weights = load_zipenhancer_modelscope(weights).state_dict()
        else:
            raise SystemExit(
                f"--weights {args.weights}: torch checkpoints are supported "
                "for --backend gtcrn (.tar) and zipenhancer-ref (ModelScope "
                "bin); use .npz for the trainable backends")
    written = enhance_batch(args.root, backend=args.backend, weights=weights,
                            device="cpu" if args.cpu else None)
    print(f"enhanced {len(written)} files")
    return 0


def cmd_demix(args) -> int:
    from .pipelines.demix import EnsembleDemixer, separate_dialog

    written = separate_dialog(args.root, args.output, EnsembleDemixer(
        device="cpu" if args.cpu else None))
    print(f"wrote {len(written)} stems")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="sdtpu-torch", description="speaker diarization (PyTorch/CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("diarize", help="diarize one file")
    p.add_argument("audio")
    p.add_argument("--out-dir", default="out")
    p.add_argument("--format", default="all",
                   choices=["rttm", "json", "srt", "csv", "all"])
    _add_common_config_args(p)
    p.set_defaults(fn=cmd_diarize)

    p = sub.add_parser("batch", help="batch-diarize a directory (with stems)")
    p.add_argument("root")
    p.add_argument("--engine", default="flagship",
                   choices=["flagship", "segmentation"],
                   help="segmentation = the chunk-local speaker-activity "
                        "engine (overlap-aware)")
    _add_common_config_args(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("diag", help="diagnostic run with plots")
    p.add_argument("audio")
    p.add_argument("--out-dir", default="out")
    _add_common_config_args(p)
    p.set_defaults(fn=cmd_diag)

    p = sub.add_parser("enhance", help="batch speech enhancement")
    p.add_argument("root")
    p.add_argument("--backend", default="gtcrn",
                   choices=["gtcrn", "zipenhancer", "zipenhancer-ref"],
                   help="zipenhancer-ref = the published ZipEnhancer graph "
                        "(loads the ModelScope bundle's state_dict)")
    p.add_argument("--weights", default=None,
                   help=".npz checkpoint override; a GTCRN DNS3 .tar with "
                        "gtcrn, a ModelScope pytorch_model.bin with "
                        "zipenhancer-ref")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--verbose", "-v", action="store_true")
    p.set_defaults(fn=cmd_enhance)

    p = sub.add_parser("demix", help="dialog/effect/music separation")
    p.add_argument("root")
    p.add_argument("--output", default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--verbose", "-v", action="store_true")
    p.set_defaults(fn=cmd_demix)

    args = parser.parse_args(argv)
    if args.verbose:
        import os

        os.environ["SDTPU_LOG_LEVEL"] = "INFO"
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

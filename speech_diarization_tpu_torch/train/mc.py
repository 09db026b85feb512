"""Multi-condition training driver: the JAX package's ``scripts/train_mc.py``
on one device (the card unless ``--cpu``).

    python -m speech_diarization_tpu_torch.train.mc vad     [--steps 600] [--cpu]
    python -m speech_diarization_tpu_torch.train.mc encoder [--steps 600] [--cpu]
    ... encoder-windowed | encoder-proto | segmentation | gtcrn |
        zipenhancer | demix

The same subcommands, flags, defaults, warm starts and output names as the
JAX driver (outputs overwrite the files under ``weights/``: these recipes
made the shipped defaults).  Warm starts read the checkpoint as float32
(``models/port.py::load_params_npz``); a missing source, or ``--cold``,
starts from the seeded init.  The multi-condition data (``train/
multicond.py``) comes from ``default_rng(--seed + 1)`` for the channels and
the recipe's own ``default_rng(--seed)`` for the rest, as in the JAX driver.
"""
from __future__ import annotations

import argparse
import logging
import time
from functools import partial
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["vad", "encoder", "encoder-windowed",
                                     "encoder-proto", "segmentation",
                                     "gtcrn", "zipenhancer", "demix"])
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--cache", type=int, default=768)
    ap.add_argument("--speakers", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cold", action="store_true",
                    help="train from scratch instead of warm-starting")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--src", type=str, default=None,
                    help="warm-start checkpoint (default: the recipe's own)")
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the CUDA card)")
    ap.add_argument("--spk-batch", type=int, default=12)
    ap.add_argument("--utt-per-spk", type=int, default=4)
    ap.add_argument("--channel-p", type=float, default=0.5)
    ap.add_argument("--competing-p", type=float, default=0.0)
    ap.add_argument("--hard-pair-frac", type=float, default=0.0,
                    help="encoder-proto: share of pool speakers rendered as "
                         "near-collided pairs")
    ap.add_argument("--snr-floor", type=float, default=8.0)
    ap.add_argument("--demix-channels", type=int, default=64)
    ap.add_argument("--demix-depth", type=int, default=5)
    ap.add_argument("--powerset", action="store_true",
                    help="segmentation: the powerset head (PIT-CE) instead of "
                         "multilabel sigmoids")
    ap.add_argument("--overlap-weight", type=float, default=0.0,
                    help="segmentation --powerset: extra loss weight on "
                         "overlapped frames")
    ap.add_argument("--seg-channels", type=int, default=96)
    ap.add_argument("--seg-hidden", type=int, default=96)
    ap.add_argument("--seg-gru", type=int, default=2)
    ap.add_argument("--seg-ds", type=int, default=1)
    ap.add_argument("--seg-arch", choices=("gru", "xf"), default="gru")
    ap.add_argument("--seg-xf", type=int, default=4)
    ap.add_argument("--seg-heads", type=int, default=4)
    ap.add_argument("--seg-mixed", action="store_true",
                    help="segmentation: half the chunks from the in-domain "
                         "generator, half multi-condition")
    ap.add_argument("--seg-conv-frac", type=float, default=0.0,
                    help="segmentation: share of chunks from the "
                         "conversation-structured generator")
    ap.add_argument("--seg-fc", type=int, default=0)
    ap.add_argument("--full-size", action="store_true",
                    help="encoder-proto --cold: the full-size EcapaTdnn")
    ap.add_argument("--proto-channels", type=int, default=None,
                    help="encoder-proto --cold: channel width of the cold net")
    return ap.parse_args(argv)


def _ecapa_from(src: Path):
    """(net, flat float32 params without the classifier) of a checkpoint,
    float32 whatever its stored dtype."""
    from ..models.ecapa import EcapaTdnn
    from ..models.port import load_params_meta, load_params_npz

    cfg = dict(load_params_meta(src).get("net", {}))
    if "dilations" in cfg:
        cfg["dilations"] = tuple(cfg["dilations"])
    flat = load_params_npz(src)
    flat.pop("classifier", None)
    return EcapaTdnn(**cfg), flat


def main(argv=None) -> int:
    from ..models.port import load_params_meta, load_params_npz
    from ..utils.logging import get_logger
    from . import recipes
    from .multicond import (
        ChannelBank, make_mc_speaker_bank, make_speaker_batch_mc,
        make_vad_example_mc,
    )

    args = parse_args(argv)
    get_logger("mc")                       # the recipes log progress at INFO
    logging.getLogger("sdtpu").setLevel(logging.INFO)
    device = "cpu" if args.cpu else None
    wroot = ROOT / "weights"
    channels = ChannelBank(np.random.default_rng(args.seed + 1))
    t0 = time.time()

    if args.what == "vad":
        src = Path(args.src) if args.src else wroot / "vad_conv_synthetic.npz"
        init = load_params_npz(src) if not args.cold and src.exists() else None
        out = args.out or wroot / "vad_conv_mc.npz"
        _, metrics = recipes.train_vad_synthetic(
            steps=args.steps or 600, batch=args.batch or 8, lr=args.lr or 1e-3,
            seed=args.seed, arch="conv", out_path=out,
            example_fn=partial(make_vad_example_mc, channels=channels),
            init_params=init, device=device)
        print(f"vad mc done in {time.time()-t0:.0f}s: "
              f"frame_acc {metrics['frame_accuracy']:.4f} -> {out}")
        return 0

    if args.what == "segmentation":
        from .multicond import make_segmentation_example_mc

        src = Path(args.src) if args.src else wroot / "segmentation_synthetic.npz"
        if not args.cold and src.exists():
            m = load_params_meta(src).get("net", {})
            if (m.get("channels", 96) != args.seg_channels
                    or m.get("hidden", 96) != args.seg_hidden
                    or m.get("n_gru", 2) != args.seg_gru
                    or m.get("n_fc", 0) != args.seg_fc
                    or m.get("ds", 1) != args.seg_ds
                    or m.get("arch", "gru") != args.seg_arch
                    or m.get("n_xf", 4) != args.seg_xf):
                print(f"segmentation: src geometry {m} != requested "
                      f"{args.seg_channels}/{args.seg_hidden}/"
                      f"gru{args.seg_gru}/fc{args.seg_fc} — cold start")
                args.cold = True
        init = None
        if not args.cold and src.exists():
            init = load_params_npz(src)
            if args.powerset and not load_params_meta(src).get(
                    "net", {}).get("powerset", False):
                # warm-start the trunk only: a sigmoid head (2h, K) cannot
                # seed the powerset head (2h, 2^K)
                from ..models.segmentation import SegNet
                from .init import init_like_jax

                fresh = init_like_jax(SegNet(
                    powerset=True, channels=args.seg_channels,
                    hidden=args.seg_hidden, n_gru=args.seg_gru,
                    n_fc=args.seg_fc), args.seed)
                init["out_w"] = fresh.out_w.detach().numpy()
                init["out_b"] = fresh.out_b.detach().numpy()
        out = args.out or wroot / "segmentation_mc.npz"
        ex_fn = partial(make_segmentation_example_mc, channels=channels)
        if args.seg_mixed or args.seg_conv_frac > 0:
            from .multicond import make_segmentation_example_conv
            from .synthetic import make_segmentation_example

            mc_fn, conv_frac = ex_fn, args.seg_conv_frac
            conv_fn = partial(make_segmentation_example_conv, channels=channels)

            def ex_fn(g):  # the conversation / in-domain / mc generator mix
                u = g.uniform()
                if u < conv_frac:
                    return conv_fn(g)
                if args.seg_mixed and u < conv_frac + (1 - conv_frac) / 2:
                    return make_segmentation_example(g)
                return mc_fn(g)
        _, metrics = recipes.train_segmentation_synthetic(
            steps=args.steps or 1500, batch=args.batch or 8, lr=args.lr or 2e-3,
            seed=args.seed, out_path=out, example_fn=ex_fn, init_params=init,
            powerset=args.powerset, channels=args.seg_channels,
            hidden=args.seg_hidden, overlap_weight=args.overlap_weight,
            n_gru=args.seg_gru, n_fc=args.seg_fc, ds=args.seg_ds,
            arch=args.seg_arch, n_xf=args.seg_xf, n_heads=args.seg_heads,
            device=device)
        print(f"segmentation mc done in {time.time()-t0:.0f}s: "
              f"best-perm acc {metrics['frame_accuracy']:.4f} -> {out}")
        return 0

    if args.what == "demix":
        from ..models.demix import DialogDemixer

        net = DialogDemixer(channels=args.demix_channels, depth=args.demix_depth)
        init = None
        if args.src:
            # a continuation run: the source's __meta__ defines the net
            net = DialogDemixer(**load_params_meta(args.src).get("net", {}))
            init = load_params_npz(args.src)
        out = args.out or wroot / "demix_mc.npz"
        _, metrics = recipes.train_demixer_synthetic(
            steps=args.steps or 800, batch=args.batch or 4, lr=args.lr or 5e-4,
            seed=args.seed, out_path=out, net=net, init_params=init,
            device=device)
        print(f"demix done in {time.time()-t0:.0f}s: per-stem SI-SNR "
              f"{metrics['si_snr_mix_db']:.2f} -> {metrics['si_snr_est_db']:.2f} dB "
              f"(+{metrics['si_snr_gain_db']:.2f}) -> {out}")
        return 0

    if args.what in ("gtcrn", "zipenhancer"):
        from .multicond import make_noisy_clean_batch_mc

        pair_fn = partial(make_noisy_clean_batch_mc, channels=channels)
        if args.what == "gtcrn":
            src = Path(args.src) if args.src else next(
                (wroot / n for n in ("gtcrn_mc.npz", "gtcrn_synthetic.npz")
                 if (wroot / n).exists()), wroot / "gtcrn_synthetic.npz")
            init = load_params_npz(src) if not args.cold and src.exists() else None
            out = args.out or wroot / "gtcrn_mc.npz"
            _, metrics = recipes.train_gtcrn_synthetic(
                steps=args.steps or 800, batch=args.batch or 8,
                lr=args.lr or 5e-4, seed=args.seed, out_path=out,
                batch_fn=pair_fn, init_params=init, device=device)
        else:
            src = (Path(args.src) if args.src
                   else wroot / "zipenhancer_synthetic.npz")
            init = load_params_npz(src) if not args.cold and src.exists() else None
            out = args.out or wroot / "zipenhancer_mc.npz"
            _, metrics = recipes.train_zipenhancer_synthetic(
                steps=args.steps or 400, batch=args.batch or 4,
                lr=args.lr or 3e-4, seed=args.seed, out_path=out,
                batch_fn=pair_fn, init_params=init, device=device)
        print(f"{args.what} mc done in {time.time()-t0:.0f}s: "
              f"SI-SNR {metrics['si_snr_noisy_db']:.2f} -> "
              f"{metrics['si_snr_enhanced_db']:.2f} dB "
              f"(+{metrics['si_snr_gain_db']:.2f}) -> {out}")
        return 0

    # the encoder recipes share the bank and batch source
    batch_fn = partial(make_speaker_batch_mc, channels=channels)

    if args.what == "encoder":
        src = Path(args.src) if args.src else wroot / "ecapa_synthetic_full_stream.npz"
        net = init = None
        if not args.cold and src.exists():
            net, init = _ecapa_from(src)
            # the classifier head only when the bank size matches
            with np.load(src) as z:
                if ("classifier" in z.files
                        and z["classifier"].shape[0] == args.speakers):
                    init["classifier"] = z["classifier"].astype(np.float32)
        out = args.out or wroot / "ecapa_mc_full_stream.npz"
        _, metrics = recipes.train_speaker_encoder_streaming(
            steps=args.steps or 600, batch=args.batch or 8,
            n_speakers=args.speakers, lr=args.lr or 5e-4, seed=args.seed,
            net=net, out_path=out, utterance_cache=args.cache,
            init_params=init, bank_fn=make_mc_speaker_bank, batch_fn=batch_fn,
            device=device)
        print(f"stream encoder mc done in {time.time()-t0:.0f}s: "
              f"probe_purity {metrics['probe_purity']:.4f} -> {out}")
        return 0

    if args.what == "encoder-proto":
        from ..models.ecapa import EcapaTdnn
        from .proto import train_speaker_encoder_proto

        src = Path(args.src) if args.src else wroot / "ecapa_mc_full_stream.npz"
        net = init = None
        if not args.cold and src.exists():
            net, init = _ecapa_from(src)
        elif args.full_size:
            net = EcapaTdnn()
        elif args.proto_channels:
            c = args.proto_channels
            net = EcapaTdnn(n_mels=40, channels=c, emb_dim=max(64, c // 2),
                            scale=4, se_channels=max(32, c // 4),
                            att_channels=max(32, c // 4))
        out = args.out or wroot / "ecapa_proto_stream.npz"
        _, metrics = train_speaker_encoder_proto(
            steps=args.steps or 2000, lr=args.lr or 3e-4, seed=args.seed,
            net=net, out_path=out, init_params=init,
            spk_per_batch=args.spk_batch, utt_per_spk=args.utt_per_spk,
            channel_p=args.channel_p, competing_p=args.competing_p,
            channel_kwargs={"snr_db": (args.snr_floor, 30.0)},
            hard_pair_frac=args.hard_pair_frac, device=device)
        print(f"proto encoder done in {time.time()-t0:.0f}s: "
              f"unseen_separation {metrics['unseen_separation']:.4f} "
              f"hard_pair_margin {metrics.get('hard_pair_margin')} -> {out}")
        return 0

    # encoder-windowed
    src = wroot / "ecapa_synthetic_full.npz"
    net = init = None
    if not args.cold and src.exists():
        net, init = _ecapa_from(src)
    out = args.out or wroot / "ecapa_mc_full.npz"
    _, metrics = recipes.train_speaker_encoder_synthetic(
        steps=args.steps or 400, batch=args.batch or 16,
        n_speakers=args.speakers, lr=args.lr or 5e-4, seed=args.seed, net=net,
        out_path=out, utterance_cache=args.cache, init_params=init,
        bank_fn=make_mc_speaker_bank, batch_fn=batch_fn, device=device)
    print(f"windowed encoder mc done in {time.time()-t0:.0f}s: "
          f"probe_purity {metrics['probe_purity']:.4f} -> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

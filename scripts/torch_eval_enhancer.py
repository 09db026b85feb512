#!/usr/bin/env python
"""Cross-family SI-SNR of enhancement checkpoints with the PyTorch port, the
port of ``scripts/eval_enhancer.py``.

A ship decision for a retrained enhancer needs both noise families: the
round-1 synthesis (``recipes.make_noisy_clean_batch``) and the
multi-condition one (``multicond.make_noisy_clean_batch_mc``: babble /
reverb beds, both voice families).  Each checkpoint runs the training
evaluation's forward: GTCRN through ``stft_ri`` / ``istft_ri`` (n_fft 512,
hop 256), or ``ZipEnhancerModel`` on the waveforms.

    python3 scripts/torch_eval_enhancer.py --backend zipenhancer \\
        --weights weights/zipenhancer_mc.npz weights/zipenhancer_synthetic.npz [--cpu]

Runs on the card unless ``--cpu`` is given.  One line per checkpoint
(noisy -> enhanced SI-SNR per family), then the card's nvidia-smi line
(``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import sys
from functools import partial
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def make_forward(backend: str, path, dev):
    """noisy [B, T] tensor -> enhanced [B, T] of the checkpoint at ``path``."""
    from speech_diarization_tpu_torch.models.port import load_gtcrn, load_zipenhancer

    if backend == "gtcrn":
        from speech_diarization_tpu_torch.dsp.stft import istft_ri, stft_ri

        net = load_gtcrn(path).to(dev).eval()

        def forward(noisy):
            return istft_ri(net(stft_ri(noisy, 512, 256)), 512, 256,
                            length=noisy.shape[-1])

        return forward
    return load_zipenhancer(path).to(dev).eval()


def evaluate(backend: str = "zipenhancer", weights=(), batch: int = 16,
             dur: float = 2.0, seed: int = 1, device=None) -> dict:
    """{checkpoint name: {family: (noisy SI-SNR, enhanced SI-SNR)}} in dB."""
    import torch

    from speech_diarization_tpu_torch.train import recipes
    from speech_diarization_tpu_torch.train.multicond import (
        ChannelBank, make_noisy_clean_batch_mc,
    )
    from speech_diarization_tpu_torch.utils.device import disable_tf32, resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    families = {
        "r1": recipes.make_noisy_clean_batch,
        "mc": partial(make_noisy_clean_batch_mc,
                      channels=ChannelBank(np.random.default_rng(seed))),
    }
    batches = {name: fn(np.random.default_rng(seed + 1), batch, dur)
               for name, fn in families.items()}
    out = {}
    for wpath in weights:
        fwd = make_forward(backend, wpath, dev)
        row = {}
        for name, (noisy, clean) in batches.items():
            with torch.inference_mode():
                enh = fwd(torch.from_numpy(np.asarray(noisy, np.float32)).to(dev))
            row[name] = (recipes.si_snr_db(noisy, clean),
                         recipes.si_snr_db(enh.float().cpu().numpy(), clean))
        out[Path(wpath).name] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=["gtcrn", "zipenhancer"],
                    default="zipenhancer")
    ap.add_argument("--weights", nargs="+", required=True)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--dur", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    res = evaluate(args.backend, args.weights, args.batch, args.dur, args.seed,
                   device=device)
    for name, row in res.items():
        cells = "  ".join(f"{fam}: {n:.2f} -> {e:.2f} dB (+{e - n:.2f})"
                          for fam, (n, e) in row.items())
        print(f"{name:36s} {cells}")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

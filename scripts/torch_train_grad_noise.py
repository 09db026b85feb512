"""How far a small change of the log-mel features moves the proto encoder's
step-1 gradient, at the shipped width (``ecapa_robust_stream.npz``, the
batch of ``chip_smoke.py``'s training phase: 12 speakers x 4 utterances x
3 s).

The phase holds the card's step 1 against the CPU's by the largest
gradient difference relative to the largest gradient.  On the card the
features come from K2, which differs from the plain float32 log-mel within
its tolerance; the stem's weight gradient sums those features.  This
script measures that sensitivity, float32 with TF32 off, on one device:

* K2's features against the plain log-mel, with the features'
  largest and root-mean-square difference;
* ``--draws`` draws of Gaussian noise of ``--sigma`` on the plain log-mel,
  each against the plain log-mel.

Each line gives the loss's relative difference, the gradients' cosine and
their largest difference over the largest |gradient|; the last line is a
JSON summary (min, median and max over the draws).

    python3 scripts/torch_train_grad_noise.py [--draws 16] [--sigma 6e-5]

Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def step1(job, wavs, feats_fn) -> tuple[float, "torch.Tensor"]:
    """Step 1's loss and flattened gradient with the utterances' features
    made by ``feats_fn`` ([B, T] -> [B, T_f, n_mels])."""
    import torch

    model = job.model

    def chunk(y, n_windows, margin, win, hop, backend=None):
        return model.encode_grid_feats(feats_fn(y), n_windows, margin, win,
                                       hop, backend=backend)

    model.encode_grid_chunk = chunk
    try:
        loss = job.loss_fn(wavs)
        loss.backward()
        vec = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                         .detach().float().reshape(-1).cpu()
                         for p in job.state.params.values()])
    finally:
        del model.encode_grid_chunk
        job.state.optimizer.zero_grad(set_to_none=True)
    return loss.item(), vec.double()


def compare(ref, got) -> dict:
    (l_r, g_r), (l_g, g_g) = ref, got
    return {"loss_rel": abs(l_g - l_r) / max(abs(l_r), 1e-12),
            "cos": float((g_r @ g_g) / (g_r.norm() * g_g.norm())),
            "grad_rel": float((g_g - g_r).abs().max() / g_r.abs().max())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=16)
    ap.add_argument("--sigma", type=float, default=6e-5)
    args = ap.parse_args()

    import torch

    from speech_diarization_tpu_torch.dsp.mel import fused_log_mel, log_mel_spectrogram
    from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn
    from speech_diarization_tpu_torch.models.port import load_params_meta, load_params_npz
    from speech_diarization_tpu_torch.train.proto import proto_job
    from speech_diarization_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    weights = ROOT / "weights" / "ecapa_robust_stream.npz"
    meta = load_params_meta(weights)["net"]
    net = EcapaTdnn(**dict(meta, dilations=tuple(meta["dilations"])))
    job = proto_job(spk_per_batch=12, utt_per_spk=4, lr=3e-4,
                    seed=7, net=net, init_params=load_params_npz(weights),
                    pool_speakers=24, pool_utts=4,
                    channel_kwargs={"snr_db": (8.0, 30.0)}, device=dev)
    wavs = torch.as_tensor(job.next_batch()[0]).to(dev)
    sr, n_mels = job.model.sample_rate, job.net.n_mels

    def plain(y):
        return log_mel_spectrogram(y, sr, n_mels)

    ref = step1(job, wavs, plain)
    rows = {"k2": compare(ref, step1(job, wavs,
                                     lambda y: fused_log_mel(y, sr, n_mels)))}
    with torch.no_grad():
        y = wavs.reshape(-1, wavs.shape[-1])
        d = fused_log_mel(y, sr, n_mels) - plain(y)
    rows["k2"].update(feat_max_abs=float(d.abs().max()),
                      feat_rms=float(d.square().mean().sqrt()))
    print(f"K2 features: {rows['k2']}")
    draws = []
    for d in range(args.draws):
        gen = torch.Generator(device=dev).manual_seed(d)

        def noisy(y, gen=gen):
            f = plain(y)
            return f + args.sigma * torch.randn(f.shape, generator=gen,
                                                device=f.device)

        draws.append(compare(ref, step1(job, wavs, noisy)))
        print(f"noise draw {d} (sigma {args.sigma:g}): {draws[-1]}")
    g = np.array([r["grad_rel"] for r in draws])
    if len(g):
        rows["noise"] = {"draws": len(g), "sigma": args.sigma,
                         "grad_rel_min": float(g.min()),
                         "grad_rel_median": float(np.median(g)),
                         "grad_rel_max": float(g.max()),
                         "cos_min": min(r["cos"] for r in draws)}
    print(json.dumps({"device": str(dev), "batch": list(wavs.shape), **rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Speaker-embedding quality of an encoder on unseen speakers with the
PyTorch port, the port of ``scripts/probe_encoder.py``.

Renders utterances of fresh speaker profiles (in no training bank) through
a synthesis family and, with ``--channel on``, a reverb / babble channel;
embeds each through the streaming grid (1 s windows at a 0.5 s hop, one
``EcapaModel.encode_grid_chunk`` call on the ``[B, T]`` batch: one log-mel
launch and one trunk pass, then one K1 launch an utterance on the card),
mean-pooled per utterance; and reports within- / across-speaker cosines,
their separation, the EER of the pairwise verification trial and a
greedy-centroid purity at the true speaker count.

    python3 scripts/torch_probe_encoder.py --enc weights/ecapa_mc_full_stream.npz \\
        --family lpc --channel on --speakers 12 --utts 8 [--cpu]

Runs on the card unless ``--cpu`` is given.  One JSON line, then the card's
nvidia-smi line (``cpu`` under ``--cpu``).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def render(speakers: int, utts: int, dur: float, seed: int, family: str,
           channel: str, sr: int = 16000) -> tuple[np.ndarray, np.ndarray]:
    """-> (waveforms [speakers * utts, dur * sr], speaker labels)."""
    from speech_diarization_tpu_torch.train.multicond import ChannelBank, render_speaker

    rng = np.random.default_rng(seed)
    channels = ChannelBank(rng) if channel == "on" else None
    # fresh profiles on a fine grid, deliberately not any bank's layout
    profs = [{"f0": float(rng.uniform(85.0, 290.0)),
              "shift": float(rng.uniform(0.84, 1.24))} for _ in range(speakers)]
    n = int(dur * sr)
    wavs, labels = [], []
    for k, prof in enumerate(profs):
        for _ in range(utts):
            fam = (family if family != "mixed"
                   else ("lpc" if rng.uniform() < 0.5 else "harm"))
            w = render_speaker(rng, prof, dur, sr, family=fam)
            if channels is not None:
                w = channels.apply(rng, w)
            wavs.append(np.pad(w[:n], (0, max(0, n - len(w)))).astype(np.float32))
            labels.append(k)
    return np.stack(wavs), np.asarray(labels)


def scores(embs: np.ndarray, labels: np.ndarray, speakers: int) -> dict:
    """Cosine statistics, EER and purity of unit utterance embeddings."""
    sim = embs @ embs.T
    same = labels[:, None] == labels[None, :]
    iu = np.triu_indices(len(labels), 1)
    within = sim[iu][same[iu]]
    across = sim[iu][~same[iu]]
    truth = same[iu]
    t = truth[np.argsort(-sim[iu])]
    pos = truth.sum()
    neg = len(truth) - pos
    fnr = 1.0 - np.cumsum(t) / pos
    fpr = np.cumsum(~t) / neg
    eer = float(fpr[np.argmin(np.abs(fnr - fpr))])
    # greedy centroid purity at the true K (cosine k-means from the first
    # utterance of each speaker)
    centroids = embs[[np.flatnonzero(labels == k)[0] for k in range(speakers)]]
    for _ in range(10):
        a = np.argmax(embs @ centroids.T, axis=1)
        centroids = np.stack([embs[a == k].mean(0) if (a == k).any() else centroids[k]
                              for k in range(speakers)])
        centroids /= np.linalg.norm(centroids, axis=1, keepdims=True) + 1e-9
    return {
        "within_mean": round(float(within.mean()), 4),
        "within_p10": round(float(np.percentile(within, 10)), 4),
        "across_mean": round(float(across.mean()), 4),
        "across_p90": round(float(np.percentile(across, 90)), 4),
        "separation": round(float(within.mean() - across.mean()), 4),
        "eer": round(eer, 4),
        "purity_at_true_k": round(float((a == labels).mean()), 4),
    }


def probe(enc: str = "weights/ecapa_synthetic_full_stream.npz",
          family: str = "mixed", channel: str = "off", speakers: int = 12,
          utts: int = 8, dur: float = 2.0, seed: int = 123, device=None) -> dict:
    """The probe's summary for the encoder in ``enc``."""
    import torch

    from speech_diarization_tpu_torch.models.port import load_speaker_encoder
    from speech_diarization_tpu_torch.utils.device import disable_tf32, resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    model = load_speaker_encoder(enc).to(dev).eval()
    sr = model.sample_rate
    wavs, labels = render(speakers, utts, dur, seed, family, channel, sr)
    # the streaming grid: 1 s windows at a 0.5 s hop, mean-pooled per utterance
    n = wavs.shape[1]
    win, hop = sr, sr // 2
    n_win = (n - win) // hop + 1
    with torch.inference_mode():
        grid = model.encode_grid_chunk(torch.from_numpy(wavs).to(dev), n_win,
                                       0, win, hop)
    embs = grid.float().cpu().numpy().astype(np.float64).mean(axis=1)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True) + 1e-9
    return {"enc": Path(enc).name, "family": family, "channel": channel,
            **scores(embs, labels, speakers)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--enc", type=str,
                    default="weights/ecapa_synthetic_full_stream.npz")
    ap.add_argument("--family", choices=["lpc", "harm", "mixed"], default="mixed")
    ap.add_argument("--channel", choices=["on", "off"], default="off")
    ap.add_argument("--speakers", type=int, default=12)
    ap.add_argument("--utts", type=int, default=8)
    ap.add_argument("--dur", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args()

    from speech_diarization_tpu_torch.utils.device import eval_device

    dv = eval_device(args.cpu)
    if dv is None:
        print("needs a CUDA card (or --cpu)", file=sys.stderr)
        return 2
    device, card = dv
    print(json.dumps(probe(args.enc, args.family, args.channel, args.speakers,
                           args.utts, args.dur, args.seed, device=device)))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

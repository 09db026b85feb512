"""Prototypical speaker-encoder training over unlimited synthetic speakers:
the JAX package's ``train/proto.py``, the recipe of the default encoder
``ecapa_robust_stream.npz``.

AAM-softmax over a fixed speaker bank memorizes the bank; the angular
prototypical loss needs no classifier, so every ``pool_refresh_steps`` the
whole speaker pool is thrown away and rendered anew with fresh profiles.
A batch is N speakers x M utterances, embedded through the streaming grid
(one K2 launch and one trunk pass over the batch, the decomposed head); an
utterance's embedding is the normalized mean of its window embeddings.
``hard_pair_frac`` renders that share of the pool as near-collided pairs
(f0 within ~3 %, same tract scale, formants within ~3 %) and forces some
into every batch.  Two probes follow training: the separation of fresh
unseen speakers, and with hard pairs the margin of fresh near-collided
pairs.  Every draw comes from ``default_rng(seed)`` in the JAX recipe's
order.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from ..models.ecapa import EcapaModel, EcapaTdnn
from ..utils.logging import get_logger
from .checkpoint import export_inference_weights
from .optim import adam
from .recipes import Job, _device, _ecapa_meta, _leaves, _refold
from .steps import TrainState

log = get_logger("proto")


def angular_proto_loss(emb: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """Angular prototypical loss of embeddings [N, M, D] (N speakers, M
    utterances each), with leave-one-out centroids for the query's own
    speaker; logits ``max(scale, 1e-3) * cos + bias``, CE over speakers."""
    n, m, _ = emb.shape
    e = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-9)
    cent = e.mean(dim=1)                                        # [N, D]
    cent_full = cent / (torch.linalg.norm(cent, dim=-1, keepdim=True) + 1e-9)
    loo = (cent[:, None, :] * m - e) / (m - 1)                  # [N, M, D]
    loo = loo / (torch.linalg.norm(loo, dim=-1, keepdim=True) + 1e-9)
    cos_other = torch.einsum("nmd,kd->nmk", e, cent_full)       # [N, M, N]
    cos_self = torch.einsum("nmd,nmd->nm", e, loo)              # [N, M]
    eye = torch.eye(n, dtype=torch.bool, device=emb.device)[:, None, :]
    cos = torch.where(eye, cos_self[..., None], cos_other)
    logits = torch.clamp(scale, min=1e-3) * cos + bias
    labels = torch.arange(n, device=emb.device)[:, None].expand(n, m)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None]).mean()


def proto_job(spk_per_batch: int = 12, utt_per_spk: int = 4, lr: float = 3e-4,
              seed: int = 0, net: EcapaTdnn | None = None,
              init_params: dict | None = None, pool_speakers: int = 160,
              pool_utts: int = 4, dur_s: float = 3.0, win_s: float = 1.0,
              hop_s: float = 0.5, channel_p: float = 0.5, family: str = "mixed",
              channel_kwargs: dict | None = None, competing_p: float = 0.0,
              competing_snr_db: tuple[float, float] = (5.0, 20.0),
              hard_pair_frac: float = 0.0, device=None) -> Job:
    """The proto recipe's model, state (the net's leaves, ``proto_scale``
    10 and ``proto_bias`` -5 unless ``init_params`` has them; Adam), loss
    and batch source.  ``job.render_pool()`` renders a pool and
    ``job.draw_batch(pool)`` draws a batch [N, M, T] from it; the first
    pool is ``job.pool``."""
    from .multicond import ChannelBank, make_mc_speaker_bank, render_speaker

    device = _device(device)
    net = net or EcapaTdnn(n_mels=40, channels=128, emb_dim=64, scale=4,
                           se_channels=32, att_channels=32)
    model = EcapaModel(net)
    sr = model.sample_rate
    n = int(dur_s * sr)
    win, hop = int(win_s * sr), int(hop_s * sr)
    n_win = (n - win) // hop + 1
    init = dict(init_params or {})
    extra = {k: nn.Parameter(torch.tensor(float(np.asarray(init.get(k, v)))))
             for k, v in (("proto_scale", 10.0), ("proto_bias", -5.0))}
    leaves = _leaves(net, seed, init_params, extra)
    model.to(device)
    for p in extra.values():
        p.data = p.data.to(device)
    state = TrainState(leaves, adam(list(leaves.values()), lr))
    rng = np.random.default_rng(seed)
    channels = ChannelBank(rng)
    n_hard_pairs = int(pool_speakers * hard_pair_frac / 2)
    hard_lo = pool_speakers - 2 * n_hard_pairs

    def render_pool():
        profs = make_mc_speaker_bank(rng, pool_speakers)
        for j in range(n_hard_pairs):
            a = profs[hard_lo + 2 * j]
            profs[hard_lo + 2 * j + 1] = {
                "f0": a["f0"] * float(rng.uniform(0.97, 1.03)),
                "shift": a["shift"],
                "formants": np.asarray(a["formants"]) * rng.uniform(0.97, 1.03, 3),
            }
        pool = np.zeros((pool_speakers, pool_utts, n), np.float32)
        for s, prof in enumerate(profs):
            for u in range(pool_utts):
                fam = (family if family != "mixed"
                       else ("lpc" if rng.uniform() < 0.5 else "harm"))
                w = render_speaker(rng, prof, dur_s, sr, family=fam)
                pool[s, u, : min(n, len(w))] = w[:n]
        return pool

    def draw_batch(pool):
        if n_hard_pairs and spk_per_batch >= 4:
            k = min(spk_per_batch // 4, n_hard_pairs)
            pids = rng.choice(n_hard_pairs, k, replace=False)
            hard = np.concatenate(
                [[hard_lo + 2 * p, hard_lo + 2 * p + 1] for p in pids])
            rest = rng.choice(hard_lo, spk_per_batch - len(hard), replace=False)
            spk = np.concatenate([hard, rest])
        else:
            spk = rng.choice(pool.shape[0], spk_per_batch, replace=False)
        out = np.empty((spk_per_batch, utt_per_spk, n), np.float32)
        for i, s in enumerate(spk):
            us = rng.choice(pool.shape[1], utt_per_spk,
                            replace=pool.shape[1] < utt_per_spk)
            for j, u in enumerate(us):
                w = pool[s, u]
                if competing_p and rng.uniform() < competing_p:
                    # a different pool speaker mixed under the foreground
                    o = int(rng.integers(0, pool.shape[0] - 1))
                    o = o + (o >= s)
                    bg = pool[o, int(rng.integers(0, pool.shape[1]))]
                    snr = float(rng.uniform(*competing_snr_db))
                    sp = float(np.mean(w.astype(np.float64) ** 2) + 1e-12)
                    bp = float(np.mean(bg.astype(np.float64) ** 2) + 1e-12)
                    g = np.sqrt(sp / (bp * 10.0 ** (snr / 10.0)))
                    w = w + (g * bg).astype(np.float32)
                if rng.uniform() < channel_p:
                    w = channels.apply(rng, w, **(channel_kwargs or {}))[:n]
                    w = np.pad(w, (0, n - len(w)))
                if rng.uniform() < 0.5:                   # pre-emphasis jitter
                    w = np.concatenate([w[:1], w[1:] - 0.97 * w[:-1]])
                gain = 10.0 ** (rng.uniform(-12.0, 6.0) / 20.0)
                out[i, j] = np.clip(w * gain, -0.99, 0.99)
        return out

    def encode(wavs):                           # [B, T] -> [B, D] utterances
        embs = model.encode_grid_chunk(wavs, n_win, 0, win, hop,
                                       backend="decomposed")
        e = embs / (torch.linalg.norm(embs, dim=-1, keepdim=True) + 1e-9)
        return e.mean(dim=1)

    def loss_fn(wavs):                                        # [N, M, T]
        emb = encode(wavs.reshape(-1, wavs.shape[-1])).reshape(
            spk_per_batch, utt_per_spk, -1)
        return angular_proto_loss(emb, extra["proto_scale"], extra["proto_bias"])

    job = Job(model, net, state, loss_fn, None, device,
              {"streaming_stats": True, "net": _ecapa_meta(net)})
    job.rng, job.encode, job.n = rng, encode, n
    job.render_pool, job.draw_batch = render_pool, draw_batch
    job.n_hard_pairs = n_hard_pairs
    job.pool = render_pool()
    job.next_batch = lambda: (draw_batch(job.pool),)
    return job


def train_speaker_encoder_proto(steps: int = 2000, spk_per_batch: int = 12,
                                utt_per_spk: int = 4, lr: float = 3e-4,
                                seed: int = 0, net: EcapaTdnn | None = None,
                                out_path: str | Path | None = None,
                                init_params: dict | None = None,
                                pool_speakers: int = 160, pool_utts: int = 4,
                                pool_refresh_steps: int = 250, dur_s: float = 3.0,
                                win_s: float = 1.0, hop_s: float = 0.5,
                                channel_p: float = 0.5, family: str = "mixed",
                                log_every: int = 50,
                                channel_kwargs: dict | None = None,
                                competing_p: float = 0.0,
                                competing_snr_db: tuple[float, float] = (5.0, 20.0),
                                hard_pair_frac: float = 0.0,
                                device=None) -> tuple[EcapaModel, dict]:
    """Fine-tune (or train) the streaming ECAPA with the angular
    prototypical objective over a regenerated speaker pool -> (model,
    metrics with the losses, ``unseen_separation`` and, with hard pairs,
    ``hard_pair_margin``); the npz says ``streaming_stats: True``."""
    from .multicond import make_mc_speaker_bank, render_speaker

    job = proto_job(spk_per_batch, utt_per_spk, lr, seed, net, init_params,
                    pool_speakers, pool_utts, dur_s, win_s, hop_s, channel_p,
                    family, channel_kwargs, competing_p, competing_snr_db,
                    hard_pair_frac, device)
    rng, n, sr = job.rng, job.n, job.model.sample_rate
    losses = []
    t0 = time.time()
    for i in range(steps):
        if i and i % pool_refresh_steps == 0:
            tp = time.time()
            job.pool = job.render_pool()
            log.info("pool refresh at step %d (%.0fs)", i, time.time() - tp)
        loss = job.step()
        if (i + 1) % log_every == 0 or i == 0:
            losses.append(float(loss))
            log.info("proto step %d loss %.4f (%.1fs)", i + 1, losses[-1],
                     time.time() - t0)
    _refold(job.net)

    def embed(wavs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            e = job.encode(job.batch_tensors((wavs,))[0]).cpu().numpy()
        return e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-9)

    # unseen-speaker probe: fresh profiles, never in any pool
    probe_pool = job.render_pool()[:24, :2]
    emb = embed(probe_pool.reshape(-1, n))
    lab = np.repeat(np.arange(probe_pool.shape[0]), probe_pool.shape[1])
    sim = emb @ emb.T
    same = lab[:, None] == lab[None, :]
    iu = np.triu_indices(len(lab), 1)
    sep = float(sim[iu][same[iu]].mean() - sim[iu][~same[iu]].mean())
    metrics = {"loss": losses, "unseen_separation": sep}
    log.info("unseen-speaker separation %.4f", sep)

    if job.n_hard_pairs:
        # hard-pair margin probe: fresh near-collided pairs; margin = within
        # -speaker cos minus cross-pair cos
        margins = []
        for _ in range(12):
            a = make_mc_speaker_bank(rng, 1)[0]
            b = {"f0": a["f0"] * float(rng.uniform(0.97, 1.03)),
                 "shift": a["shift"],
                 "formants": np.asarray(a["formants"]) * rng.uniform(0.97, 1.03, 3)}
            ws = []
            for prof in (a, a, b, b):
                w = render_speaker(rng, prof, dur_s, sr)
                ws.append(np.pad(w[:n], (0, max(0, n - len(w[:n])))))
            e = embed(np.stack(ws).astype(np.float32))
            within = 0.5 * (e[0] @ e[1] + e[2] @ e[3])
            cross = float(np.mean(e[:2] @ e[2:].T))
            margins.append(float(within - cross))
        metrics["hard_pair_margin"] = float(np.mean(margins))
        log.info("hard-pair margin %.4f", metrics["hard_pair_margin"])

    if out_path is not None:
        export_inference_weights(out_path, job.net, job.meta)
    return job.model, metrics

"""The training recipes of the JAX package's ``train/recipes.py`` on one
device (the card unless ``device='cpu'``).

Each recipe draws its batches from ``np.random.default_rng(seed)`` in the
JAX recipe's order (batch k is byte-equal to the JAX recipe's batch k),
trains in float32 (TF32 off on the card) with the JAX recipe's optimizer
(``train/optim.py``), logs the loss at the JAX recipe's steps, scores the
same probe and exports the same flat npz (keys and ``__meta__``).  Weights:
``init_params``, a flat dict of arrays by the JAX flat keys (a checkpoint
read with ``models/port.py::load_params_npz``, or a JAX params tree
flattened by :func:`_flatten`), else the port's own seeded init
(``train/init.py``); the JAX recipe's ``jax.random`` draws are not
reproducible here.  The log-mel of every step is kernel K2 on the card;
the streaming encoder pools through the plain differentiable head
(``backend='decomposed'``), as the JAX recipes do, since K1 has no
backward.  The loaders are ``models/port.py``'s; ``load_*_weights`` give
the state dicts of the nets they build (warm starts).

Each recipe is a ``*_job`` (model, :class:`~.steps.TrainState`, loss,
batch source) and a loop over it; the jobs are what the tests and the
card's smoke test drive step by step.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..models.ecapa import EcapaModel, EcapaTdnn
# the JAX module's loaders, as models/port.py defines them: each returns
# the loaded module where the JAX one returns (model, params)
from ..models.port import (  # noqa: F401
    load_demixer, load_segmentation, load_speaker_encoder, load_vad)
from ..models.vad import VadConvNet, VadModel, VadNet
from ..utils.device import disable_tf32, resolve_device
from ..utils.logging import get_logger
from .checkpoint import export_inference_weights
from .init import init_like_jax
from .objectives import aam_softmax_loss, bce_vad_loss, si_snr_loss
from .optim import adam, adamw, cosine_decay
from .steps import TrainState, apply_step, load_flat, net_params, on_device
from .synthetic import make_speaker_bank, make_speaker_batch, make_vad_example

log = get_logger("recipes")


@dataclass
class Job:
    """A recipe's training loop, one step at a time.  ``loss_fn(*batch)``
    takes the batch's tensors on ``device``; ``next_batch()`` draws the
    next numpy batch from the recipe's generator; ``meta`` is the
    ``__meta__`` the recipe's export writes."""
    model: nn.Module
    net: nn.Module
    state: TrainState
    loss_fn: Callable
    next_batch: Callable[[], tuple]
    device: torch.device
    meta: dict | None = None

    def step(self, batch: tuple | None = None) -> torch.Tensor:
        batch = self.next_batch() if batch is None else batch
        return apply_step(self.state, self.loss_fn,
                          *on_device(self.device, *batch))

    def batch_tensors(self, batch: tuple) -> tuple[torch.Tensor, ...]:
        return on_device(self.device, *batch)


def _device(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    return dev


def _leaves(net: nn.Module, seed: int, init_params: dict | None,
            extra: dict | None = None) -> dict[str, nn.Parameter]:
    """The net's leaves from ``init_params`` (which may hold more, such as
    a classifier) or the seeded init, then ``extra``."""
    if init_params is None:
        init_like_jax(net, seed)
    leaves = net_params(net)
    if init_params is not None:
        load_flat(leaves, init_params)
    leaves.update(extra or {})
    return leaves


def _refold(net: nn.Module) -> None:
    """The ECAPA's K1 constants follow its weights (after optimizer steps
    they are stale until refolded)."""
    if hasattr(net, "fold_k1"):
        net.fold_k1()


# ---------------------------------------------------------------- VAD -----
def vad_job(batch: int = 8, dur_s: float = 4.0, lr: float = 2e-3,
            seed: int = 0, arch: str = "gru", example_fn=None,
            init_params: dict | None = None, device=None) -> Job:
    device = _device(device)
    net = VadConvNet() if arch == "conv" else VadNet()
    model = VadModel(net)
    leaves = _leaves(net, seed, init_params)
    model.to(device)
    state = TrainState(leaves, adam(list(leaves.values()), lr))
    rng = np.random.default_rng(seed)
    example_fn = example_fn or make_vad_example

    def next_batch():
        ws, ls = zip(*(example_fn(rng, dur_s) for _ in range(batch)))
        return np.stack(ws), np.stack(ls)

    def loss_fn(wavs, labels):
        probs = model.probs(wavs)
        n = min(probs.shape[-1], labels.shape[-1])
        return bce_vad_loss(probs[..., :n], labels[..., :n])

    meta = {"arch": arch}
    if arch == "conv":
        meta["net"] = {"n_mels": net.n_mels, "channels": net.channels,
                       "dilations": list(net.dilations), "kernel": net.kernel}
    return Job(model, net, state, loss_fn, next_batch, device, meta)


def train_vad_synthetic(steps: int = 300, batch: int = 8, dur_s: float = 4.0,
                        lr: float = 2e-3, seed: int = 0,
                        out_path: str | Path | None = None,
                        eval_every: int = 50, arch: str = "gru",
                        example_fn=None, init_params: dict | None = None,
                        device=None) -> tuple[VadModel, dict]:
    """Train the VAD ('gru': the recurrent net; 'conv': the TCN) on
    synthetic speech and noise with frame BCE and Adam -> (model, metrics
    with the losses and the held-out frame accuracy).  ``example_fn(rng,
    dur_s) -> (wave, frame_labels)`` overrides the data source (e.g.
    ``multicond.make_vad_example_mc``)."""
    job = vad_job(batch, dur_s, lr, seed, arch, example_fn, init_params, device)
    metrics = {"loss": []}
    for i in range(steps):
        loss = job.step()
        if (i + 1) % eval_every == 0 or i == 0:
            metrics["loss"].append(float(loss))
            log.info("vad step %d loss %.4f", i + 1, metrics["loss"][-1])
    wavs, labels = job.next_batch()
    with torch.no_grad():
        probs = job.model.probs(job.batch_tensors((wavs,))[0]).cpu().numpy()
    n = min(probs.shape[-1], labels.shape[-1])
    metrics["frame_accuracy"] = float(
        ((probs[..., :n] > 0.5) == (labels[..., :n] > 0.5)).mean())
    log.info("vad heldout frame accuracy %.3f", metrics["frame_accuracy"])
    if out_path is not None:
        export_inference_weights(out_path, job.net, job.meta)
    return job.model, metrics


# ----------------------------------------------------- speaker encoders ----
def _ecapa_meta(net: EcapaTdnn) -> dict:
    return {"n_mels": net.n_mels, "channels": net.channels,
            "emb_dim": net.emb_dim, "scale": net.scale,
            "se_channels": net.se_channels, "att_channels": net.att_channels,
            "dilations": list(net.dilations)}


def _small_ecapa() -> EcapaTdnn:
    return EcapaTdnn(n_mels=40, channels=128, emb_dim=64, scale=4,
                     se_channels=32, att_channels=32)


def _classifier(init_params: dict | None, n_speakers: int, emb_dim: int,
                seed: int) -> nn.Parameter:
    """The AAM head: the warm start's when it has one, else 0.05 N(0, 1)."""
    if init_params is not None and "classifier" in init_params:
        return nn.Parameter(torch.as_tensor(
            np.asarray(init_params["classifier"], np.float32)).clone())
    g = torch.Generator().manual_seed(seed + 1)
    return nn.Parameter(0.05 * torch.randn(n_speakers, emb_dim, generator=g))


def _speaker_source(rng, n_speakers, utterance_cache, bank_fn, batch_fn,
                    dur_s=None):
    """The JAX recipes' speaker data: a bank, then batches drawn live or
    from a cache of ``utterance_cache`` utterances with fresh gain and
    pre-emphasis per draw.  -> ``draw(g, b) -> (wavs, labels)``."""
    bank_fn = bank_fn or make_speaker_bank
    make_batch = batch_fn or make_speaker_batch
    kw = {} if dur_s is None else {"dur_s": dur_s}
    bank = bank_fn(rng, n_speakers)
    if not utterance_cache:
        return lambda g, b: make_batch(g, bank, b, **kw)
    cw, cl = make_batch(rng, bank, utterance_cache, preprocess_aug=False, **kw)

    def draw(g, b):
        idx = g.integers(0, len(cw), size=b)
        ws = cw[idx].copy()
        for i in range(b):
            if g.uniform() < 0.5:
                ws[i, 1:] = ws[i, 1:] - 0.97 * ws[i, :-1]
            gain = 10.0 ** (g.uniform(-12.0, 6.0) / 20.0)
            ws[i] = np.clip(ws[i] * gain, -0.99, 0.99)
        return ws, cl[idx]

    return draw


def _probe_purity(emb: np.ndarray, labels: np.ndarray, n_speakers: int) -> float:
    """Nearest-centroid accuracy over the speakers present in the probe."""
    e = emb / (np.linalg.norm(emb, axis=1, keepdims=True) + 1e-9)
    present = [k for k in range(n_speakers) if (labels == k).any()]
    centroids = np.stack([e[labels == k].mean(0) for k in present])
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True) + 1e-9
    pred = np.asarray(present)[np.argmax(e @ centroids.T, axis=1)]
    return float((pred == labels).mean())


def speaker_encoder_job(batch: int = 16, n_speakers: int = 12, lr: float = 1e-3,
                        seed: int = 0, net: EcapaTdnn | None = None,
                        utterance_cache: int = 0,
                        init_params: dict | None = None, bank_fn=None,
                        batch_fn=None, device=None) -> Job:
    """The windowed recipe: per-utterance embeddings (``encode_batch``:
    K2, then the trunk and head with running-statistics BN), AAM-softmax,
    Adam."""
    device = _device(device)
    net = net or _small_ecapa()
    model = EcapaModel(net)
    cls = _classifier(init_params, n_speakers, net.emb_dim, seed)
    leaves = _leaves(net, seed, init_params, {"classifier": cls})
    model.to(device)
    cls.data = cls.data.to(device)
    state = TrainState(leaves, adam(list(leaves.values()), lr))
    rng = np.random.default_rng(seed)
    draw = _speaker_source(rng, n_speakers, utterance_cache, bank_fn, batch_fn)

    def loss_fn(wavs, labels):
        return aam_softmax_loss(model.encode_batch(wavs), cls, labels)

    job = Job(model, net, state, loss_fn, lambda: draw(rng, batch), device,
              {"net": _ecapa_meta(net)})
    job.draw, job.rng = draw, rng
    return job


def train_speaker_encoder_synthetic(steps: int = 150, batch: int = 16,
                                    n_speakers: int = 12, lr: float = 1e-3,
                                    seed: int = 0, net: EcapaTdnn | None = None,
                                    out_path: str | Path | None = None,
                                    utterance_cache: int = 0,
                                    init_params: dict | None = None,
                                    bank_fn=None, batch_fn=None,
                                    device=None) -> tuple[EcapaModel, dict]:
    """Train an ECAPA on synthetic speakers with AAM-softmax, per
    utterance -> (model, metrics with the losses and the probe purity)."""
    job = speaker_encoder_job(batch, n_speakers, lr, seed, net, utterance_cache,
                              init_params, bank_fn, batch_fn, device)
    losses = []
    for i in range(steps):
        loss = job.step()
        if (i + 1) % 25 == 0 or i == 0:
            losses.append(float(loss))
            log.info("spk step %d loss %.4f", i + 1, losses[-1])
    _refold(job.net)
    wavs, labels = job.draw(job.rng, 3 * n_speakers)
    with torch.no_grad():
        emb = job.model.encode_batch(job.batch_tensors((wavs,))[0]).cpu().numpy()
    metrics = {"loss": losses,
               "probe_purity": _probe_purity(emb, labels, n_speakers)}
    log.info("speaker probe purity %.3f", metrics["probe_purity"])
    if out_path is not None:
        export_inference_weights(out_path, job.net, job.meta,
                                 extra={"classifier": job.state.params["classifier"]})
    return job.model, metrics


def stream_encoder_job(batch: int = 8, n_speakers: int = 12, lr: float = 1e-3,
                       seed: int = 0, net: EcapaTdnn | None = None,
                       utterance_cache: int = 0, dur_s: float = 3.0,
                       win_s: float = 1.0, hop_s: float = 0.5,
                       init_params: dict | None = None, bank_fn=None,
                       batch_fn=None, device=None) -> Job:
    """The streaming recipe: each utterance's windows pooled from ONE
    trunk pass with sliding statistics (``encode_grid_chunk`` over the
    batch: one K2 launch, one trunk pass, the decomposed head), AAM-softmax
    over every window, Adam."""
    device = _device(device)
    net = net or _small_ecapa()
    model = EcapaModel(net)
    sr = model.sample_rate
    win, hop = int(round(win_s * sr)), int(round(hop_s * sr))
    n_win = (int(round(dur_s * sr)) - win) // hop + 1
    cls = _classifier(init_params, n_speakers, net.emb_dim, seed)
    leaves = _leaves(net, seed, init_params, {"classifier": cls})
    model.to(device)
    cls.data = cls.data.to(device)
    state = TrainState(leaves, adam(list(leaves.values()), lr))
    rng = np.random.default_rng(seed)
    draw = _speaker_source(rng, n_speakers, utterance_cache, bank_fn, batch_fn,
                           dur_s=dur_s)

    def encode(wavs):                                 # [B, T] -> [B*n_win, D]
        emb = model.encode_grid_chunk(wavs, n_win, 0, win, hop,
                                      backend="decomposed")
        return emb.reshape(-1, emb.shape[-1])

    def loss_fn(wavs, labels):
        return aam_softmax_loss(encode(wavs), cls,
                                labels.repeat_interleave(n_win))

    job = Job(model, net, state, loss_fn, lambda: draw(rng, batch), device,
              {"streaming_stats": True, "net": _ecapa_meta(net)})
    job.draw, job.rng, job.encode, job.n_win = draw, rng, encode, n_win
    return job


def train_speaker_encoder_streaming(steps: int = 300, batch: int = 8,
                                    n_speakers: int = 12, lr: float = 1e-3,
                                    seed: int = 0, net: EcapaTdnn | None = None,
                                    out_path: str | Path | None = None,
                                    utterance_cache: int = 0,
                                    dur_s: float = 3.0, win_s: float = 1.0,
                                    hop_s: float = 0.5,
                                    init_params: dict | None = None,
                                    bank_fn=None, batch_fn=None,
                                    device=None) -> tuple[EcapaModel, dict]:
    """Train an ECAPA under the streaming grid's statistics regime ->
    (model, metrics with the losses and the window probe purity); the npz
    says ``streaming_stats: True``."""
    job = stream_encoder_job(batch, n_speakers, lr, seed, net, utterance_cache,
                             dur_s, win_s, hop_s, init_params, bank_fn,
                             batch_fn, device)
    losses = []
    for i in range(steps):
        loss = job.step()
        if (i + 1) % 25 == 0 or i == 0:
            losses.append(float(loss))
            log.info("stream-spk step %d loss %.4f", i + 1, losses[-1])
    _refold(job.net)
    wavs, labels = job.draw(job.rng, 3 * n_speakers)
    with torch.no_grad():
        emb = job.encode(job.batch_tensors((wavs,))[0]).cpu().numpy()
    metrics = {"loss": losses, "probe_purity": _probe_purity(
        emb, np.repeat(labels, job.n_win), n_speakers)}
    log.info("streaming speaker probe purity %.3f", metrics["probe_purity"])
    if out_path is not None:
        export_inference_weights(
            out_path, job.net, job.meta,
            extra={"classifier": job.state.params["classifier"]})
    return job.model, metrics


# ----------------------------------------------------------- enhancers -----
def make_noisy_clean_batch(rng: np.random.Generator, batch: int,
                           dur_s: float = 2.0, sr: int = 16000,
                           snr_db: tuple[float, float] = (-5.0, 10.0)
                           ) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic enhancement pairs: speech-like clean + shaped noise mixed at
    a random SNR (a zero-power negative is redrawn, up to 8 times)."""
    from .synthetic import synth_negative, synth_speech_like

    noisy, clean = [], []
    for _ in range(batch):
        c = synth_speech_like(rng, dur_s, sr)
        for _ in range(8):
            n = synth_negative(rng, dur_s, sr)
            if float(np.mean(n**2)) > 1e-9:
                break
        n = n[: len(c)] if len(n) >= len(c) else np.pad(n, (0, len(c) - len(n)))
        snr = rng.uniform(*snr_db)
        pc = np.mean(c**2) + 1e-12
        pn = np.mean(n**2) + 1e-12
        n = n * np.sqrt(pc / pn / (10.0 ** (snr / 10.0)))
        x = c + n
        peak = max(np.abs(x).max(), 1.0)
        noisy.append((x / peak).astype(np.float32))
        clean.append((c / peak).astype(np.float32))
    return np.stack(noisy), np.stack(clean)


def si_snr_db(est: np.ndarray, ref: np.ndarray) -> float:
    """Scale-invariant SNR in dB (per-utterance mean)."""
    est = est - est.mean(axis=-1, keepdims=True)
    ref = ref - ref.mean(axis=-1, keepdims=True)
    proj = (np.sum(est * ref, -1, keepdims=True)
            / (np.sum(ref * ref, -1, keepdims=True) + 1e-8)) * ref
    noise = est - proj
    ratio = np.sum(proj**2, -1) / (np.sum(noise**2, -1) + 1e-8)
    return float(np.mean(10.0 * np.log10(ratio + 1e-8)))


def _enhance_metrics(enhance: Callable, batch_fn, seed: int, n: int,
                     dur_s: float, device) -> dict:
    """Held-out SI-SNR before and after, on ``n`` pairs from
    ``default_rng(seed + 1)``."""
    noisy, clean = batch_fn(np.random.default_rng(seed + 1), n, dur_s)
    with torch.no_grad():
        enh = enhance(on_device(device, noisy)[0]).cpu().numpy()
    m = {"si_snr_noisy_db": si_snr_db(noisy, clean),
         "si_snr_enhanced_db": si_snr_db(enh, clean)}
    m["si_snr_gain_db"] = m["si_snr_enhanced_db"] - m["si_snr_noisy_db"]
    return m


def gtcrn_job(batch: int = 8, dur_s: float = 2.0, lr: float = 1e-3,
              seed: int = 0, n_fft: int = 512, hop: int = 256, batch_fn=None,
              init_params: dict | None = None, device=None) -> Job:
    """GTCRN on noisy / clean pairs: STFT -> net -> iSTFT, SI-SNR, AdamW."""
    from ..dsp.stft import istft_ri, stft_ri
    from ..models.gtcrn import GTCRN

    device = _device(device)
    net = GTCRN()
    leaves = _leaves(net, seed, init_params)
    net.to(device)
    state = TrainState(leaves, adamw(list(leaves.values()), lr))
    rng = np.random.default_rng(seed)
    batch_fn = batch_fn or make_noisy_clean_batch

    def enhance(noisy):
        spec = stft_ri(noisy, n_fft, hop)
        return istft_ri(net(spec), n_fft, hop, length=noisy.shape[-1])

    def loss_fn(noisy, clean):
        return si_snr_loss(enhance(noisy), clean)

    job = Job(net, net, state, loss_fn, lambda: batch_fn(rng, batch, dur_s),
              device)
    job.enhance = enhance
    return job


def train_gtcrn_synthetic(steps: int = 400, batch: int = 8, dur_s: float = 2.0,
                          lr: float = 1e-3, seed: int = 0,
                          out_path: str | Path | None = None,
                          eval_every: int = 50, n_fft: int = 512,
                          hop: int = 256, batch_fn=None,
                          init_params: dict | None = None,
                          device=None) -> tuple[nn.Module, dict]:
    """Train GTCRN for enhancement with SI-SNR -> (net, metrics with the
    losses and the held-out SI-SNR of 16 pairs before and after).
    ``batch_fn(rng, batch, dur_s) -> (noisy, clean)`` overrides the data
    source (e.g. ``multicond.make_noisy_clean_batch_mc``)."""
    job = gtcrn_job(batch, dur_s, lr, seed, n_fft, hop, batch_fn, init_params,
                    device)
    metrics = {"loss": []}
    for i in range(steps):
        loss = job.step()
        if (i + 1) % eval_every == 0 or i == 0:
            metrics["loss"].append(float(loss))
            log.info("gtcrn step %d si-snr loss %.3f", i + 1, metrics["loss"][-1])
    metrics.update(_enhance_metrics(job.enhance, batch_fn or make_noisy_clean_batch,
                                    seed, 16, dur_s, job.device))
    log.info("gtcrn heldout SI-SNR: noisy %.2f dB -> enhanced %.2f dB (+%.2f)",
             metrics["si_snr_noisy_db"], metrics["si_snr_enhanced_db"],
             metrics["si_snr_gain_db"])
    if out_path is not None:
        export_inference_weights(out_path, job.net)
    return job.net, metrics


def zipenhancer_job(batch: int = 4, dur_s: float = 2.0, lr: float = 5e-4,
                    seed: int = 0, net: nn.Module | None = None, batch_fn=None,
                    init_params: dict | None = None, device=None) -> Job:
    from ..models.zipenhancer import ZipEnhancerModel

    device = _device(device)
    net = net or ZipEnhancerModel()
    leaves = _leaves(net, seed, init_params)
    net.to(device)
    state = TrainState(leaves, adamw(list(leaves.values()), lr))
    rng = np.random.default_rng(seed)
    batch_fn = batch_fn or make_noisy_clean_batch

    def loss_fn(noisy, clean):
        return si_snr_loss(net(noisy), clean)

    job = Job(net, net, state, loss_fn, lambda: batch_fn(rng, batch, dur_s),
              device)
    job.enhance = net
    return job


def train_zipenhancer_synthetic(steps: int = 300, batch: int = 4,
                                dur_s: float = 2.0, lr: float = 5e-4,
                                seed: int = 0, out_path: str | Path | None = None,
                                eval_every: int = 50, net: nn.Module | None = None,
                                batch_fn=None, init_params: dict | None = None,
                                device=None) -> tuple[nn.Module, dict]:
    """Train the ZipEnhancer-class model with SI-SNR (the contract of
    :func:`train_gtcrn_synthetic`; 8 held-out pairs)."""
    job = zipenhancer_job(batch, dur_s, lr, seed, net, batch_fn, init_params,
                          device)
    metrics = {"loss": []}
    for i in range(steps):
        loss = job.step()
        if (i + 1) % eval_every == 0 or i == 0:
            metrics["loss"].append(float(loss))
            log.info("zipenhancer step %d si-snr loss %.3f", i + 1,
                     metrics["loss"][-1])
    metrics.update(_enhance_metrics(job.enhance, batch_fn or make_noisy_clean_batch,
                                    seed, 8, dur_s, job.device))
    if out_path is not None:
        export_inference_weights(out_path, job.net)
    return job.net, metrics


def demixer_job(batch: int = 4, dur_s: float = 1.0, lr: float = 5e-4,
                seed: int = 0, net: nn.Module | None = None,
                init_params: dict | None = None, device=None) -> Job:
    """The demixer on synthetic stereo mixtures at 44.1 kHz, per-stem
    SI-SNR, AdamW."""
    from ..models.demix import DialogDemixer
    from .synthetic import make_demix_example

    device = _device(device)
    net = net or DialogDemixer()
    leaves = _leaves(net, seed, init_params)
    net.to(device)
    state = TrainState(leaves, adamw(list(leaves.values()), lr))
    rng = np.random.default_rng(seed)

    def draw(g):
        ms, ss = zip(*(make_demix_example(g, dur_s, 44100) for _ in range(batch)))
        return np.stack(ms), np.stack(ss)

    def loss_fn(mix, stems):
        est = net(mix)                                     # [B, 3, 2, T]
        b, s, c, t = est.shape
        return si_snr_loss(est.reshape(b * s * c, t), stems.reshape(b * s * c, t))

    job = Job(net, net, state, loss_fn, lambda: draw(rng), device, {"net": {
        "channels": net.c, "depth": net.depth, "kernel": net.k, "stride": net.s,
        "bottleneck_blocks": net.nb, "sources": net.sources,
        "audio_channels": net.ac}})
    job.draw = draw
    return job


def train_demixer_synthetic(steps: int = 300, batch: int = 4, dur_s: float = 1.0,
                            lr: float = 5e-4, seed: int = 0,
                            out_path: str | Path | None = None,
                            eval_every: int = 50, net: nn.Module | None = None,
                            init_params: dict | None = None,
                            device=None) -> tuple[nn.Module, dict]:
    """Train the dialog / effect / music demixer -> (net, metrics with the
    held-out per-stem SI-SNR of the mixture and of the estimate)."""
    job = demixer_job(batch, dur_s, lr, seed, net, init_params, device)
    metrics = {"loss": []}
    for i in range(steps):
        loss = job.step()
        if (i + 1) % eval_every == 0 or i == 0:
            metrics["loss"].append(float(loss))
            log.info("demix step %d si-snr loss %.3f", i + 1, metrics["loss"][-1])
    mix, stems = job.draw(np.random.default_rng(seed + 1))
    with torch.no_grad():
        est = job.net(job.batch_tensors((mix,))[0]).cpu().numpy()
    b, s, c, t = est.shape
    ref = stems.reshape(b * s * c, t)
    metrics["si_snr_mix_db"] = si_snr_db(
        np.broadcast_to(mix[:, None], stems.shape).reshape(b * s * c, t), ref)
    metrics["si_snr_est_db"] = si_snr_db(est.reshape(b * s * c, t), ref)
    metrics["si_snr_gain_db"] = metrics["si_snr_est_db"] - metrics["si_snr_mix_db"]
    if out_path is not None:
        export_inference_weights(out_path, job.net, job.meta)
    return job.net, metrics


# -------------------------------------------------------- segmentation -----
def segmentation_job(steps: int = 400, batch: int = 8, dur_s: float = 5.0,
                     max_speakers: int = 3, lr: float = 2e-3, seed: int = 0,
                     example_fn=None, init_params: dict | None = None,
                     powerset: bool = False, channels: int = 96,
                     hidden: int = 96, overlap_weight: float = 0.0,
                     n_gru: int = 2, n_fc: int = 0, ds: int = 1,
                     arch: str = "gru", n_xf: int = 4, n_heads: int = 4,
                     device=None) -> Job:
    """The segmentation net on overlapping-speech chunks: PIT-CE over the
    powerset head or PIT-BCE over sigmoids, Adam on a cosine decay to 5 %
    over ``steps``."""
    from ..models.segmentation import (
        SegmentationModel, SegNet, pit_bce_loss, powerset_pit_ce_loss,
    )
    from .synthetic import make_segmentation_example

    device = _device(device)
    net = SegNet(channels=channels, hidden=hidden, n_speakers=max_speakers,
                 powerset=powerset, n_gru=n_gru, n_fc=n_fc, ds=ds, arch=arch,
                 n_xf=n_xf, n_heads=n_heads)
    model = SegmentationModel(net)
    leaves = _leaves(net, seed, init_params)
    model.to(device)
    opt = adam(list(leaves.values()), lr)
    state = TrainState(leaves, opt, cosine_decay(opt, steps, 0.05))
    rng = np.random.default_rng(seed)
    ex_fn = example_fn or (
        lambda g: make_segmentation_example(g, dur_s, max_speakers=max_speakers))

    def draw(g):
        ws, ls = zip(*(ex_fn(g) for _ in range(batch)))
        return np.stack(ws), np.stack(ls)

    def loss_fn(wavs, labels):
        if powerset:
            logits = model.head_logits(wavs)
            n = min(logits.shape[1], labels.shape[1])
            return powerset_pit_ce_loss(logits[:, :n], labels[:, :n],
                                        overlap_weight=overlap_weight)
        act = model.activities(wavs)
        n = min(act.shape[1], labels.shape[1])
        return pit_bce_loss(act[:, :n], labels[:, :n])

    net_meta = {"channels": channels, "hidden": hidden,
                "n_speakers": max_speakers, "powerset": powerset,
                "n_gru": n_gru, "n_fc": n_fc, "ds": ds}
    if arch != "gru":
        net_meta.update(arch=arch, n_xf=n_xf, n_heads=n_heads)
    job = Job(model, net, state, loss_fn, lambda: draw(rng), device,
              {"net": net_meta})
    job.draw = draw
    return job


def train_segmentation_synthetic(steps: int = 400, batch: int = 8,
                                 dur_s: float = 5.0, max_speakers: int = 3,
                                 lr: float = 2e-3, seed: int = 0,
                                 out_path: str | Path | None = None,
                                 eval_every: int = 50, example_fn=None,
                                 init_params: dict | None = None,
                                 powerset: bool = False, channels: int = 96,
                                 hidden: int = 96, overlap_weight: float = 0.0,
                                 n_gru: int = 2, n_fc: int = 0, ds: int = 1,
                                 arch: str = "gru", n_xf: int = 4,
                                 n_heads: int = 4,
                                 device=None) -> tuple[nn.Module, dict]:
    """Train the chunk-local segmentation net -> (model, metrics with the
    losses and the held-out best-permutation frame accuracy by the head's
    own decision).  Every 1000 steps short of the end the npz is written
    with ``steps_done``, so a lost machine leaves the latest weights."""
    from ..models.segmentation import best_permutation_accuracy

    job = segmentation_job(steps, batch, dur_s, max_speakers, lr, seed,
                           example_fn, init_params, powerset, channels, hidden,
                           overlap_weight, n_gru, n_fc, ds, arch, n_xf, n_heads,
                           device)
    metrics = {"loss": []}
    for i in range(steps):
        loss = job.step()
        if (i + 1) % eval_every == 0 or i == 0:
            metrics["loss"].append(float(loss))
            log.info("seg step %d pit loss %.4f", i + 1, metrics["loss"][-1])
        if out_path is not None and (i + 1) % 1000 == 0 and (i + 1) < steps:
            export_inference_weights(out_path, job.net, {
                **job.meta, "steps_done": i + 1, "steps_total": steps})
            log.info("seg checkpoint @%d -> %s", i + 1, out_path)
    wavs, labels = job.draw(np.random.default_rng(seed + 1))
    with torch.no_grad():
        act = job.model.hard_activities(job.batch_tensors((wavs,))[0]).cpu().numpy()
    n = min(act.shape[1], labels.shape[1])
    metrics["frame_accuracy"] = best_permutation_accuracy(act[:, :n], labels[:, :n])
    log.info("seg heldout best-perm frame accuracy %.3f", metrics["frame_accuracy"])
    if out_path is not None:
        export_inference_weights(out_path, job.net, job.meta)
    return job.model, metrics


# ------------------------------------------------------ flat parameters ----
def _flatten(tree, prefix: str = "") -> dict:
    """A nested params tree (dicts, lists, named tuples such as the JAX
    ``GRUParams``) -> flat dict with '/'-joined keys, the npz format."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_params(flat: dict) -> dict:
    """Inverse of :func:`_flatten`: '/'-separated keys -> nested dicts, and
    lists where every key of a level is a digit (a GRU's four arrays stay a
    dict)."""
    nested: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = nested
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(nested)


def load_vad_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """The state dict of the VAD that :func:`~..models.port.load_vad` builds
    from ``path`` (float32): building that net and loading this equals the
    loader."""
    from ..models.port import load_vad

    return load_vad(path).net.state_dict()


def load_segmentation_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """The state dict of the overlap detector's net that
    :func:`~..models.port.load_segmentation` builds from ``path``."""
    from ..models.port import load_segmentation

    return load_segmentation(path).net.state_dict()


def load_demixer_weights(path: str | Path) -> dict[str, torch.Tensor]:
    """The state dict of the :class:`DialogDemixer` that
    :func:`~..models.port.load_demixer` builds from ``path``."""
    from ..models.port import load_demixer

    return load_demixer(path).state_dict()

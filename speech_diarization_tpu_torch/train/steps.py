"""Training state and steps on one device.

The JAX package jits its steps over a mesh (batch along 'dp', large
parameters along 'tp'); here a step runs on one device, named where the JAX
functions take the mesh, and ``shard_state`` moves the state onto it.  Data
parallelism is ROADMAP Queue 1 item 7.

A :class:`TrainState` holds the trained leaves by their JAX flat keys (the
net's parameters, BatchNorm statistics included, and extras such as the
AAM classifier), the optimizer (its state is ``opt_state``), an optional
learning-rate schedule and the step count.  :func:`apply_step` is one
update: zero the grads, the loss, backward, the optimizer, the schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..models.ecapa import EcapaTdnn
from ..models.layers import make_trainable
from ..models.port import DOTTED_NETS, flat_key
from ..utils.device import disable_tf32, resolve_device
from .init import init_like_jax
from .objectives import aam_softmax_loss, si_snr_loss
from .optim import adamw


@dataclass
class TrainState:
    params: dict[str, nn.Parameter]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0

    @property
    def opt_state(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": (None if self.scheduler is None
                              else self.scheduler.state_dict())}


def net_params(net: nn.Module, extra: dict | None = None) -> dict[str, nn.Parameter]:
    """``net``'s leaves (made trainable: ``models/layers.py::
    make_trainable``) by their JAX flat keys, then ``extra``."""
    make_trainable(net)
    dotted = isinstance(net, DOTTED_NETS)
    out = {flat_key(k, dotted): p for k, p in net.named_parameters()}
    out.update(extra or {})
    return out


def load_flat(params: dict[str, nn.Parameter], flat: dict) -> None:
    """Copy a flat dict of arrays (JAX flat keys, e.g. a JAX params tree
    flattened by ``recipes._flatten``) into the leaves; every leaf must be
    given."""
    missing = sorted(set(params) - set(flat))
    if missing:
        raise KeyError(f"no values for {missing[:5]} ({len(missing)} leaves)")
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(torch.from_numpy(np.array(flat[k], np.float32)))


def apply_step(state: TrainState, loss_fn: Callable, *batch) -> torch.Tensor:
    """One update; returns the loss (detached, on the device: reading it
    waits for the card)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(*batch)
    loss.backward()
    # a leaf the loss does not reach (the running statistics under
    # train-mode BN) gets a zero gradient, as in optax: its moments and the
    # step count advance with the rest, and AdamW decays it
    for p in state.params.values():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    return loss.detach()


def on_device(device, *arrays) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(np.asarray(a)).to(device) for a in arrays)


def make_ecapa_train_step(device, net: EcapaTdnn, n_classes: int,
                          optimizer: Callable | None = None,
                          sample_rate: int = 16000):
    """(init_fn, step_fn, shard_state) for ECAPA speaker-ID training:
    K2's log-mel of the batch (``fbank_batch``, one launch on the card), the
    net with train-mode BatchNorm (batch statistics), AAM-softmax against
    the classifier prototypes [n_classes, emb_dim], AdamW (lr 1e-3, decay
    1e-4 unless ``optimizer(params)`` makes another).

    ``init_fn(seed=0, params=None)``: the net from ``seed``
    (``train/init.py``) and the classifier ``0.05 N(0, 1)``, or ``params``
    (a flat dict with a ``classifier``) -> :class:`TrainState`.
    ``step_fn(state, wavs [B, T], labels [B]) -> (state, loss)``; its
    ``loss_fn(params, wavs, labels)`` is the loss alone.
    ``shard_state(state)`` moves the state onto ``device``."""
    from ..dsp.mel import fbank_batch

    device = resolve_device(device)
    if device.type == "cuda":
        disable_tf32()
    make_opt = optimizer or (lambda ps: adamw(ps, 1e-3))

    def init_fn(seed: int = 0, params: dict | None = None) -> TrainState:
        g = torch.Generator().manual_seed(seed + 1)
        cls = nn.Parameter(0.05 * torch.randn(n_classes, net.emb_dim, generator=g))
        if params is None:
            init_like_jax(net, seed)
        leaves = net_params(net, {"classifier": cls})
        if params is not None:
            load_flat(leaves, params)
        return TrainState(leaves, make_opt(list(leaves.values())))

    def loss_fn(params, wavs, labels):
        feats = fbank_batch(wavs, sample_rate=sample_rate, n_mels=net.n_mels)
        emb = net.embed_utterances(feats, train=True)
        return aam_softmax_loss(emb, params["classifier"], labels)

    def step_fn(state: TrainState, wavs, labels):
        wavs, labels = on_device(device, wavs, labels)
        return state, apply_step(state, loss_fn, state.params, wavs, labels)

    step_fn.loss_fn = loss_fn

    def shard_state(state: TrainState) -> TrainState:
        net.to(device)
        state.params["classifier"].data = state.params["classifier"].data.to(device)
        _optimizer_to(state.optimizer, device)
        return state

    return init_fn, step_fn, shard_state


def make_gtcrn_train_step(device, optimizer: Callable | None = None,
                          n_fft: int = 512, hop: int = 256):
    """(init_fn, step_fn) for GTCRN enhancement training: noisy / clean
    pairs [B, T], SI-SNR through STFT -> net -> iSTFT, AdamW (lr 1e-3,
    decay 1e-4).  ``init_fn(seed=0, params=None)`` makes the net (on
    ``device``) and its :class:`TrainState`; the net is ``state.net``."""
    from ..dsp.stft import istft_ri, stft_ri
    from ..models.gtcrn import GTCRN

    device = resolve_device(device)
    if device.type == "cuda":
        disable_tf32()
    make_opt = optimizer or (lambda ps: adamw(ps, 1e-3))
    net = GTCRN()

    def init_fn(seed: int = 0, params: dict | None = None) -> TrainState:
        if params is None:
            init_like_jax(net, seed)
        leaves = net_params(net)
        if params is not None:
            load_flat(leaves, params)
        net.to(device)
        state = TrainState(leaves, make_opt(list(leaves.values())))
        state.net = net
        return state

    def loss_fn(noisy, clean):
        spec = stft_ri(noisy, n_fft, hop)
        wav = istft_ri(net(spec), n_fft, hop, length=noisy.shape[-1])
        return si_snr_loss(wav, clean)

    def step_fn(state: TrainState, noisy, clean):
        noisy, clean = on_device(device, noisy, clean)
        return state, apply_step(state, loss_fn, noisy, clean)

    step_fn.loss_fn = loss_fn

    return init_fn, step_fn


def _optimizer_to(opt: torch.optim.Optimizer, device) -> None:
    for st in opt.state.values():
        for k, v in st.items():
            if torch.is_tensor(v) and k != "step":
                st[k] = v.to(device)

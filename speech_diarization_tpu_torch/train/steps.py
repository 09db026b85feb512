"""Training state and steps, on one device or on a mesh.

Given a device, a step runs there, and ``shard_state`` moves the state onto
it.  Given a :class:`~..parallel.mesh.Mesh` (the JAX steps jit over one),
the batch is cut into row blocks along 'dp'; each dp row runs a replica of
the net on its first device with its copies of ONE set of leaves, made
before the shards start by ``parallel/collective.py::broadcast`` (its
backward sums the ranks' gradients in rank order, so every gradient
reaches those leaves as one sum and one optimizer steps them); the leaves
named by ``ECAPA_TP_PATTERNS`` are stored split along their first dim over
the tp devices of the mesh's first row
(:class:`~..parallel.sharding.SplitLeaf`), gathered once on the first
device and broadcast; the loss is the mean over the whole batch.
Train-mode BatchNorm in a mesh step takes the statistics of the whole batch
(``models/ecapa.py::batch_stats``), as the JAX jit reduces them over the
sharded batch: the ECAPA shards run in threads that meet at each
statistic.  A mesh step is bitwise reproducible on the CPU, and on the card
under ``torch.use_deterministic_algorithms``, whichever thread runs which
shard.

A :class:`TrainState` holds the trained leaves by their JAX flat keys (the
net's parameters, BatchNorm statistics included, and extras such as the
AAM classifier; a split leaf as its pieces), the optimizer (its state is
``opt_state``), an optional learning-rate schedule and the step count.
:func:`apply_step` is one update: zero the grads, the loss, backward, the
optimizer, the schedule.
"""
from __future__ import annotations

import contextlib
import copy
import weakref
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..models.ecapa import EcapaTdnn
from ..models.layers import make_trainable
from ..models.port import DOTTED_NETS, flat_key
from ..parallel import collective
from ..parallel.mesh import Mesh
from ..parallel.sharding import SplitLeaf, param_partition_specs, shard_batch
from ..utils.device import disable_tf32, resolve_device
from .init import init_like_jax
from .objectives import aam_softmax_loss, si_snr_loss
from .optim import adamw

# parameter keys whose leading (output) dim is split over 'tp' in the ECAPA
# mesh step (the JAX package's ECAPA_TP_PATTERNS)
ECAPA_TP_PATTERNS = ("mfa", "att_w1", "att_w2", "fc_w", "classifier")


@dataclass
class TrainState:
    params: dict[str, nn.Parameter | SplitLeaf]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    step: int = 0

    @property
    def opt_state(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": (None if self.scheduler is None
                              else self.scheduler.state_dict())}


def leaf_list(params: dict) -> list[nn.Parameter]:
    """Every parameter an optimizer steps: the leaves, a split one's pieces
    in order."""
    out = []
    for p in params.values():
        out.extend(p.pieces if isinstance(p, SplitLeaf) else [p])
    return out


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
    for p in leaf_list(state.params):
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    state.optimizer.step()
    if state.scheduler is not None:
        state.scheduler.step()
    state.step += 1
    return loss.detach()


def on_device(device, *arrays) -> tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(np.asarray(a)).to(device) for a in arrays)


def _resolve(mesh_or_device) -> tuple[Mesh | None, torch.device]:
    if isinstance(mesh_or_device, Mesh):
        mesh, device = mesh_or_device, mesh_or_device.first
    else:
        mesh, device = None, resolve_device(mesh_or_device)
    if device.type == "cuda":
        disable_tf32()
    return mesh, device


class MeshReplicas:
    """A net's replicas on a mesh's dp rows, each computing with copies of
    one set of leaves (the state's, by JAX flat key), on the row's first
    device."""

    def __init__(self, mesh: Mesh, net: nn.Module,
                 tp_patterns: tuple[str, ...] = ()):
        self.mesh = mesh
        self.net = net
        self.tp_patterns = tp_patterns
        self.devices = [mesh.devices[i, 0] for i in range(mesh.devices.shape[0])]
        self.replicas: list[nn.Module] = []
        self.params: dict | None = None
        self._workers: collective.ShardWorkers | None = None

    @property
    def workers(self) -> collective.ShardWorkers | None:
        """The shards' long-lived threads, made at first use (none for one
        dp row)."""
        if self._workers is None and len(self.devices) > 1:
            self._workers = collective.ShardWorkers(self.devices)
            # the threads end with the replicas
            weakref.finalize(self, self._workers.close, False)
        return self._workers

    def place(self, state: TrainState, make_opt: Callable) -> TrainState:
        """A fresh state onto the mesh: replicated leaves onto its first
        device (the same parameters), the others split into pieces over
        its first row's tp devices, and ``make_opt`` on those leaves; the
        replicas made."""
        if state.step or state.optimizer.state or state.scheduler is not None:
            raise ValueError("place a state on a mesh before its first step, "
                             "without a schedule")
        specs = param_partition_specs(state.params, self.mesh, self.tp_patterns)
        placed = {}
        with torch.no_grad():
            for k, p in state.params.items():
                if specs[k].axis is None:
                    p.data = p.data.to(self.mesh.first)
                    placed[k] = p
                else:
                    placed[k] = SplitLeaf.split(p, self.mesh.row(0), trainable=True)
        state.params, state.optimizer = placed, make_opt(leaf_list(placed))
        self.attach(placed)
        return state

    def attach(self, params: dict) -> None:
        self.params = params
        self.net.to(self.mesh.first)
        self.replicas = [copy.deepcopy(self.net).to(d).requires_grad_(False)
                         for d in self.devices]

    def broadcast(self, params: dict | None = None) -> list[dict[str, torch.Tensor]]:
        """Each rank's copies of the leaves (``params``, default those
        attached) by flat key, made on the calling thread by
        :func:`~..parallel.collective.broadcast` (a split leaf gathered on
        the first device first): each leaf's or piece's gradient is one sum
        over the ranks in rank order."""
        params = self.params if params is None else params
        first = self.mesh.first
        copies = collective.broadcast(
            [p.gather(first) if isinstance(p, SplitLeaf) else p for p in params.values()],
            self.devices)
        return [dict(zip(params, rank)) for rank in copies]

    @contextlib.contextmanager
    def bound(self, rank: int, leaves: dict[str, torch.Tensor]):
        """Replica ``rank`` computing with ``leaves`` (rank ``rank``'s part
        of :meth:`broadcast`): yields (replica, the extra leaves by flat
        key, e.g. the classifier)."""
        dotted = isinstance(self.net, DOTTED_NETS)
        keys = {flat_key(k, dotted): k for k, _ in self.net.named_parameters()}
        extra = {k: v for k, v in leaves.items() if k not in keys}
        with collective.bind(self.replicas[rank], {keys[k]: v for k, v in leaves.items()
                                                   if k in keys}) as rep:
            yield rep, extra


def make_ecapa_train_step(mesh_or_device, net: EcapaTdnn, n_classes: int,
                          optimizer: Callable | None = None,
                          sample_rate: int = 16000):
    """(init_fn, step_fn, shard_state) for ECAPA speaker-ID training:
    K2's log-mel of the batch (``fbank_batch``, one launch on the card, or
    one a shard), the net with train-mode BatchNorm (batch statistics), AAM-softmax against
    the classifier prototypes [n_classes, emb_dim], AdamW (lr 1e-3, decay
    1e-4 unless ``optimizer(params)`` makes another).

    ``init_fn(seed=0, params=None)``: the net from ``seed``
    (``train/init.py``) and the classifier ``0.05 N(0, 1)``, or ``params``
    (a flat dict with a ``classifier``) -> :class:`TrainState`.
    ``step_fn(state, wavs [B, T], labels [B]) -> (state, loss)``; its
    ``loss_fn(params, wavs, labels)`` is the loss alone, its ``replicas``
    the :class:`MeshReplicas` on a mesh (``workers``: the shard threads),
    else None.
    ``shard_state(state)`` moves the state onto the device, or places it
    on the mesh (``ECAPA_TP_PATTERNS`` split over 'tp'); on a mesh, B must
    be a multiple of dp."""
    from ..dsp.mel import fbank_batch

    mesh, device = _resolve(mesh_or_device)
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

    if mesh is None:
        def loss_fn(params, wavs, labels):
            feats = fbank_batch(wavs, sample_rate=sample_rate, n_mels=net.n_mels)
            emb = net.embed_utterances(feats, train=True)
            return aam_softmax_loss(emb, params["classifier"], labels)

        def shard_state(state: TrainState) -> TrainState:
            net.to(device)
            state.params["classifier"].data = state.params["classifier"].data.to(device)
            _optimizer_to(state.optimizer, device)
            return state
    else:
        reps = MeshReplicas(mesh, net, ECAPA_TP_PATTERNS)

        def loss_fn(params, wavs, labels):
            """The whole batch's mean loss: each shard's log-mel (one K2
            launch), replica and AAM loss in its own thread, BatchNorm
            statistics over every shard."""
            w_blk, l_blk = shard_batch(mesh, wavs), shard_batch(mesh, labels)
            leaves = reps.broadcast(params)

            def shard(r: int) -> torch.Tensor:
                feats = fbank_batch(w_blk[r], sample_rate=sample_rate,
                                    n_mels=net.n_mels)
                with reps.bound(r, leaves[r]) as (rep, extra):
                    emb = rep.embed_utterances(feats, train=True)
                    return (aam_softmax_loss(emb, extra["classifier"], l_blk[r])
                            * w_blk[r].shape[0])

            parts = collective.run_shards(reps.devices, shard, reps.workers)
            return sum(x.to(mesh.first) for x in parts) / wavs.shape[0]

        def shard_state(state: TrainState) -> TrainState:
            return reps.place(state, make_opt)

    def step_fn(state: TrainState, wavs, labels):
        wavs, labels = on_device(device if mesh is None else torch.device("cpu"),
                                 wavs, labels)
        return state, apply_step(state, loss_fn, state.params, wavs, labels)

    step_fn.loss_fn = loss_fn
    step_fn.replicas = None if mesh is None else reps
    return init_fn, step_fn, shard_state


def make_gtcrn_train_step(mesh_or_device, optimizer: Callable | None = None,
                          n_fft: int = 512, hop: int = 256):
    """(init_fn, step_fn) for GTCRN enhancement training: noisy / clean
    pairs [B, T], SI-SNR through STFT -> net -> iSTFT, AdamW (lr 1e-3,
    decay 1e-4).  ``init_fn(seed=0, params=None)`` makes the net (on the
    device, or the mesh's first device with a replica a dp row) and its
    :class:`TrainState`; the net is ``state.net``.  On a mesh the pairs go
    along 'dp' (B a multiple of dp), each shard through its replica in
    turn: GTCRN's rows are independent.  ``step_fn.loss_fn`` is the loss
    alone, ``step_fn.replicas`` the :class:`MeshReplicas` (None on a
    device)."""
    from ..dsp.stft import istft_ri, stft_ri
    from ..models.gtcrn import GTCRN

    mesh, device = _resolve(mesh_or_device)
    make_opt = optimizer or (lambda ps: adamw(ps, 1e-3))
    net = GTCRN()
    reps = None if mesh is None else MeshReplicas(mesh, net)

    def init_fn(seed: int = 0, params: dict | None = None) -> TrainState:
        if params is None:
            init_like_jax(net, seed)
        leaves = net_params(net)
        if params is not None:
            load_flat(leaves, params)
        net.to(device)
        state = TrainState(leaves, make_opt(list(leaves.values())))
        state.net = net
        if reps is not None:
            reps.attach(leaves)
        return state

    def si_snr(model, noisy, clean):
        spec = stft_ri(noisy, n_fft, hop)
        wav = istft_ri(model(spec), n_fft, hop, length=noisy.shape[-1])
        return si_snr_loss(wav, clean)

    if reps is None:
        def loss_fn(noisy, clean):
            return si_snr(net, noisy, clean)
    else:
        def loss_fn(noisy, clean):
            parts, leaves = [], reps.broadcast()
            for r, (nb, cb) in enumerate(zip(shard_batch(mesh, noisy),
                                             shard_batch(mesh, clean))):
                with collective.on_device(reps.devices[r]), \
                        reps.bound(r, leaves[r]) as (rep, _):
                    parts.append(si_snr(rep, nb, cb) * nb.shape[0])
            return sum(x.to(mesh.first) for x in parts) / noisy.shape[0]

    def step_fn(state: TrainState, noisy, clean):
        noisy, clean = on_device(device if mesh is None else torch.device("cpu"),
                                 noisy, clean)
        return state, apply_step(state, loss_fn, noisy, clean)

    step_fn.loss_fn = loss_fn
    step_fn.replicas = reps
    return init_fn, step_fn


def _optimizer_to(opt: torch.optim.Optimizer, device) -> None:
    for st in opt.state.values():
        for k, v in st.items():
            if torch.is_tensor(v) and k != "step":
                st[k] = v.to(device)

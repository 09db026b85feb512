"""Sharded single-file inference: one file's window grid across a mesh (the
JAX package's ``parallel/inference.py``).

``pipelines/corpus.py`` spreads FILES over cards; with fewer files than
cards, the window grid of each file is spread instead.  A batch of
waveform windows is cut into row blocks along 'dp'; each dp row holds a
replica of the encoder on its first device, and the output is gathered on
the mesh's first device.  Leaves named by ``tp_patterns`` are stored
split along their first dim over the row's tp devices and gathered at use
(the whole leaf is assembled on the row's first device for each call),
not computed column-parallel: the encoder's code runs unchanged.

Numerical contract: the result equals the single-device result (the rows
are independent), as ``tests/test_torch_parallel.py`` asserts on a mesh of
eight CPU devices and ``chip_smoke.py`` phase 8 on a virtual mesh of the
card.
"""
from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from .collective import bind, on_device
from .mesh import Mesh
from .sharding import SplitLeaf, module_leaves, param_partition_specs, shard_batch, split_rows


class ShardedEncoder:
    """``encode_batch`` ([B, T] -> [B, D]) of a model replicated over a
    mesh's dp rows.  It is neither streaming-trained nor has a trunk entry
    (``encode_grid_chunk``), so a pipeline takes the windowed grid with it,
    as the JAX pipeline does with a bare ``encode_fn``; it carries no
    calibrated refine threshold for the same reason.  A pipeline takes it
    as ``encoder=`` and does not move it."""

    streaming_trained = False
    refine_sub_cos = None

    def __init__(self, model: torch.nn.Module, params, mesh: Mesh,
                 tp_patterns: tuple[str, ...] = ()):
        self.mesh = mesh
        self.device = mesh.first
        model = copy.deepcopy(model).eval()
        leaves = module_leaves(model)
        if params is not None:
            missing = sorted(set(leaves) - set(params))
            if missing:
                raise KeyError(f"encode_params lacks {missing[:5]} "
                               f"({len(missing)} leaves)")
            with torch.no_grad():
                for k, (_, t) in leaves.items():
                    t.copy_(torch.from_numpy(np.array(params[k], np.float32)))
        specs = param_partition_specs(model, mesh, tp_patterns)
        split = {k for k, s in specs.items() if s.axis is not None}
        self.replicas: list[torch.nn.Module] = []
        self._split: list[dict[str, SplitLeaf]] = []
        for i in range(mesh.shape[mesh.axis_names[0]]):
            row = mesh.row(i)
            rep = copy.deepcopy(model).to(row[0])
            rep_leaves = module_leaves(rep)
            pieces = {}
            for k in split:
                key, t = rep_leaves[k]
                pieces[key] = SplitLeaf.split(t, row)
            # the whole copies of the split leaves go: a call without the
            # gathered pieces fails instead of reading them
            with torch.no_grad():
                for key in pieces:
                    owner, _, name = key.rpartition(".")
                    mod = rep.get_submodule(owner) if owner else rep
                    table = mod._parameters if name in mod._parameters else mod._buffers
                    table[name] = None
            self.replicas.append(rep)
            self._split.append(pieces)

    def call(self, i: int, method: str, *args, **kwargs):
        """``replicas[i].method(*args)`` with the replica's split leaves
        gathered, its device current."""
        rep = self.replicas[i]
        dev = self.mesh.devices[i, 0]
        with on_device(dev):
            gathered = {k: s.gather(dev) for k, s in self._split[i].items()}
            with bind(rep, gathered):
                return getattr(rep, method)(*args, **kwargs)

    def encode_batch(self, wavs) -> torch.Tensor:
        """[B, T] -> [B, D] float32 on the mesh's first device: row blocks
        along dp (any B; the larger blocks first, empty ones skipped)."""
        if not torch.is_tensor(wavs):
            wavs = torch.as_tensor(np.asarray(wavs, np.float32))
        dp = len(self.replicas)
        outs = []
        for i, blk in enumerate(split_rows(wavs, dp)):
            if blk.shape[0] or (i == 0 and wavs.shape[0] == 0):
                outs.append(self.call(i, "encode_batch",
                                      blk.to(self.mesh.devices[i, 0])))
        return torch.cat([o.to(self.device) for o in outs])

    __call__ = encode_batch


def make_sharded_encode_fn(model, params, mesh: Mesh,
                           tp_patterns: tuple[str, ...] = ()) -> ShardedEncoder:
    """``model.encode_batch`` with the window-batch dimension sharded over
    the mesh's 'dp' axis, as a :class:`ShardedEncoder`: a drop-in
    ``encoder`` for :class:`~..pipelines.diarize.DiarizationPipeline`.
    ``params``: a flat dict under the JAX flat keys (``models/port.py::
    flat_key``), or None for the model's own weights."""
    return ShardedEncoder(model, params, mesh, tp_patterns)


def make_sharded_framewise_fn(fn: Callable, mesh: Mesh) -> Callable:
    """Shard a chunk-batched framewise function ([G, T] -> [G, F], e.g. the
    VAD's probabilities) over 'dp' when dp divides G, each block on its
    row's first device, the output gathered on the mesh's first device;
    otherwise the whole batch runs on the first device (the JAX rule)."""
    dp = mesh.shape[mesh.axis_names[0]]

    def framewise(x):
        if not torch.is_tensor(x):
            x = torch.as_tensor(np.asarray(x))
        if x.ndim >= 1 and x.shape[0] % dp == 0:
            outs = []
            for i, blk in enumerate(shard_batch(mesh, x)):
                with on_device(mesh.devices[i, 0]):
                    outs.append(fn(blk))
            return torch.cat([o.to(mesh.first) for o in outs])
        with on_device(mesh.first):
            return fn(x.to(mesh.first))

    return framewise

"""Sharding specs: batch layout and the parameter partition rule (the JAX
package's ``parallel/sharding.py``).

A :class:`Sharding` says how a tensor lies on a mesh: ``axis='dp'`` (row
blocks along dp, each on its row's first device), ``axis='tp'`` (dim 0 in
``tp`` pieces on a row's tp devices) or ``axis=None`` (whole, replicated).
:class:`SplitLeaf` is a leaf stored in tp pieces, gathered where it is
used.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .mesh import Mesh


@dataclass(frozen=True)
class Sharding:
    mesh: Mesh
    axis: str | None = None       # the mesh axis dim 0 is split over


def batch_spec(mesh: Mesh) -> Sharding:
    """[B, ...] arrays sharded along dp, replicated along tp."""
    return Sharding(mesh, "dp")


def replicate(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def shard_batch(mesh: Mesh, x) -> list[torch.Tensor]:
    """Row blocks of ``x`` along dp, block ``i`` on ``mesh.devices[i, 0]``
    (a view of ``x`` where that is its device).  A row count that dp does
    not divide raises, as the JAX ``device_put`` does."""
    x = _as_tensor(x)
    dp = mesh.shape[mesh.axis_names[0]]
    if x.ndim < 1 or x.shape[0] % dp:
        raise ValueError(f"cannot shard {tuple(x.shape)} along dp={dp}: the "
                         f"rows must be a multiple of dp")
    return [blk.to(mesh.devices[i, 0])
            for i, blk in enumerate(x.split(x.shape[0] // dp))]


def split_rows(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``n`` row blocks of ``x`` (views), as even as possible, the larger
    first (``numpy.array_split``'s rule); some are empty when ``n`` exceeds
    the rows."""
    return list(torch.tensor_split(x, n))


def _leaf_paths(params) -> dict[str, Any]:
    """JAX flat key -> leaf, from a flat dict of arrays (kept as given) or
    a module (its ``state_dict`` under the keys of ``models/port.py::
    flat_key``, relative to the module's ``net`` when it wraps one)."""
    if isinstance(params, torch.nn.Module):
        return {k: v for k, (_, v) in module_leaves(params).items()}
    return dict(params)


def module_leaves(model: torch.nn.Module) -> dict[str, tuple[str, torch.Tensor]]:
    """JAX flat key -> (``state_dict`` key in ``model``, tensor): the
    checkpoint's names of the leaves of ``model``, or of its ``net``."""
    from ..models.port import DOTTED_NETS, flat_key

    net = getattr(model, "net", None)
    prefix = "net." if isinstance(net, torch.nn.Module) else ""
    net = net if prefix else model
    dotted = isinstance(net, DOTTED_NETS)
    return {flat_key(k, dotted): (prefix + k, v)
            for k, v in net.state_dict(keep_vars=True).items()}


def param_partition_specs(params, mesh: Mesh,
                          tp_patterns: tuple[str, ...] = ()) -> dict[str, Sharding]:
    """Partition specs of a flat param dict (JAX flat keys) or a module's
    leaves: a leaf whose key contains one of ``tp_patterns``, and whose
    first dim (output channels / classes) tp divides, gets that dim sharded
    over 'tp'; everything else is replicated (the JAX rule, matched
    against the same keys)."""
    tp_size = mesh.shape[mesh.axis_names[1]]

    def spec_for(key: str, leaf) -> Sharding:
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        if (tp_size > 1 and any(pat in key for pat in tp_patterns)
                and len(shape) >= 1 and shape[0] % tp_size == 0):
            return Sharding(mesh, mesh.axis_names[1])
        return Sharding(mesh, None)

    return {k: spec_for(k, v) for k, v in _leaf_paths(params).items()}


class SplitLeaf:
    """A leaf stored split along dim 0: ``pieces[j]`` (a parameter when it
    trains) on the j-th tp device.  :meth:`gather` is the whole leaf on a
    device, differentiably: the gradients reach the pieces."""

    def __init__(self, pieces: list[torch.Tensor]):
        self.pieces = list(pieces)

    @classmethod
    def split(cls, t: torch.Tensor, devices, trainable: bool = False) -> SplitLeaf:
        with torch.no_grad():
            parts = [p.detach().to(d).clone()
                     for p, d in zip(t.chunk(len(devices)), devices)]
        if trainable:
            parts = [torch.nn.Parameter(p) for p in parts]
        return cls(parts)

    def gather(self, device) -> torch.Tensor:
        return torch.cat([p.to(device) for p in self.pieces])

    @property
    def device(self) -> torch.device:
        return self.pieces[0].device

    @property
    def shape(self) -> torch.Size:
        p = self.pieces[0]
        return torch.Size((sum(q.shape[0] for q in self.pieces), *p.shape[1:]))

    @property
    def grad(self) -> torch.Tensor | None:
        """The whole leaf's gradient on the first piece's device (zero for
        a piece the loss did not reach), or None when no piece has one."""
        if all(p.grad is None for p in self.pieces):
            return None
        return torch.cat([(torch.zeros_like(p) if p.grad is None else p.grad)
                          .to(self.device) for p in self.pieces])

    def detach(self) -> torch.Tensor:
        return self.gather(self.device).detach()

    def copy_(self, src: torch.Tensor) -> SplitLeaf:
        with torch.no_grad():
            for p, s in zip(self.pieces,
                            src.split([q.shape[0] for q in self.pieces])):
                p.copy_(s.to(p.device))
        return self

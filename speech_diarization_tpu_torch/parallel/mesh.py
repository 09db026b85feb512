"""Device meshes: a ``[dp, tp]`` array of torch devices that one process
drives (the JAX package's ``parallel/mesh.py``).

A mesh may name one device more than once.  That is the port's virtual
mesh, the counterpart of the JAX tests' eight virtual CPU devices: eight
times ``cpu`` in the tests, a few times ``cuda:0`` on a one-card machine.
On a machine with several cards, :func:`make_mesh` takes the real ones.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def default_mesh_shape(n_devices: int, tp: int = 1) -> tuple[int, int]:
    """(dp, tp) factorization of ``n_devices``; tp clamped to a divisor."""
    tp = max(1, tp)
    while n_devices % tp != 0:
        tp -= 1
    return n_devices // tp, tp


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """``devices``: an object array ``[dp, tp]`` of ``torch.device``;
    ``shape``: ``{axis name: size}``; ``axis_names``: the two names."""

    def __init__(self, devices, axis_names: tuple[str, str] = ("dp", "tp")):
        arr = np.asarray(devices, dtype=object)
        if arr.ndim != 2 or len(axis_names) != 2:
            raise ValueError("a mesh is a [dp, tp] array with two axis names")
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def first(self) -> torch.device:
        """Where outputs are gathered and the training state's replicated
        leaves live."""
        return self.devices[0, 0]

    def row(self, i: int) -> list[torch.device]:
        """The tp devices of dp row ``i``."""
        return list(self.devices[i])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[[str(d) for d in r] for r in self.devices]})")


def make_mesh(n_devices: int | None = None, tp: int = 1,
              axis_names: tuple[str, str] = ("dp", "tp"),
              devices: Sequence | None = None) -> Mesh:
    """A 2-D ('dp', 'tp') mesh over the first ``n_devices`` devices,
    dp-major.  ``devices``: any torch devices or names, repeats allowed;
    default every CUDA card, which raises without one, and also when
    ``n_devices`` asks for more cards than there are."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass devices=[...] (e.g. "
                               "['cpu'] * 8) for a mesh of CPU devices")
        n_cards = torch.cuda.device_count()
        if n_devices is not None and n_devices > n_cards:
            raise ValueError(f"asked for {n_devices} devices, this machine has "
                             f"{n_cards} CUDA card(s); name a virtual mesh "
                             f"with devices=[...]")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    dp, tp = default_mesh_shape(len(devices), tp)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, tp), axis_names)

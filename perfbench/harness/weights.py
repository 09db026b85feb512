"""Seeded weights made on the device, for a configuration that ships no
checkpoint.

The recipe is that of ``models/registry.py::seeded_state_dict`` in the port
(commit c463948): convolution and linear weights N(0, 1/fan_in), BatchNorm
running means N(0, 0.1^2), running variances U(0.5, 1.5), gains
U(0.8, 1.2), other one-dimensional weights U(0.8, 1.2), biases
N(0, 0.05^2).  The draws are not the numpy ones: they come from one
``torch.Generator`` on the device, in two calls (one normal, one uniform)
over all leaves at once, and every leaf is a slice of them, scaled.  The
same seed gives the same weights, which the program and the reference both
load.
"""
from __future__ import annotations

import numpy as np
import torch


def _kind(key: str, shape: tuple, bn: set, manifest: dict):
    """(distribution, a, b): 'n' draws a + b * N(0, 1), 'u' a + (b - a) * U."""
    prefix, leaf = key.rsplit(".", 1)
    if leaf == "running_mean":
        return "n", 0.0, 0.1
    if leaf == "running_var":
        return "u", 0.5, 1.5
    if prefix in bn and leaf == "weight":
        return "u", 0.8, 1.2
    if leaf == "weight" and len(shape) == 1:
        return ("u", 0.8, 1.2) if f"{prefix}.bias" in manifest else ("u", 0.2, 0.3)
    if len(shape) >= 2:
        return "n", 0.0, float((1.0 / np.prod(shape[1:])) ** 0.5)
    return "n", 0.0, 0.05


def seeded_state_dict_on_device(manifest: dict[str, tuple[int, ...]], seed: int,
                                device) -> dict[str, torch.Tensor]:
    """A float32 state_dict for ``manifest`` (key -> shape) drawn on
    ``device`` from ``seed``, in sorted key order."""
    bn = {k.rsplit(".", 1)[0] for k in manifest if k.endswith("running_mean")}
    keys = sorted(manifest)
    kinds = {k: _kind(k, tuple(manifest[k]), bn, manifest) for k in keys}
    sizes = {k: int(np.prod(manifest[k])) if len(manifest[k]) else 1 for k in keys}
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    n_norm = sum(sizes[k] for k in keys if kinds[k][0] == "n")
    n_unif = sum(sizes[k] for k in keys if kinds[k][0] == "u")
    draws = {"n": torch.randn(n_norm, generator=g, device=device),
             "u": torch.rand(n_unif, generator=g, device=device)}
    offs = {"n": 0, "u": 0}
    out = {}
    for k in keys:
        dist, a, b = kinds[k]
        o, n = offs[dist], sizes[k]
        x = draws[dist][o:o + n]
        offs[dist] = o + n
        v = a + b * x if dist == "n" else a + (b - a) * x
        out[k] = v.reshape(tuple(manifest[k])).contiguous()
    return out

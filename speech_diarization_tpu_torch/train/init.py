"""Seeded initial weights for nets trained from scratch.

The port cannot reproduce the JAX package's ``jax.random`` draws; a cold
start here draws from a ``torch.Generator`` with the distributions of the
JAX inits instead:

* weights of two or more dims: He normal as ``jax.nn.initializers.
  he_normal`` (truncated at two standard deviations, variance 2 / fan_in,
  fan_in by JAX's convention: ``shape[-2]`` times the product of the dims
  before it);
* biases and BatchNorm means zero, BatchNorm gains and variances and
  layer-norm gains one, learned positions ``0.02 N(0, 1)``;
* GRUs uniform in +-1/sqrt(hidden);
* the demixer's decoder convolutions scaled by 0.1;
* GTCRN: torch's default inits (uniform in +-1/sqrt(fan_in), the
  distributions of ``gtcrn_init_params``), PReLU slopes 0.25, the ERB
  filterbank fixed.

Warm starts and the parity tests load weights instead
(``models/port.py::params_from_numpy``).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..models.demix import DialogDemixer
from ..models.gtcrn import GTCRN, erb_filterbank
from ..models.layers import BatchNorm

_ONES = ("bn_gamma", "bn_var", "gamma", "var", "running_var")
_ZEROS = ("bn_beta", "bn_mean", "beta", "mean", "running_mean")


def he_normal_(t: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    fan_in = t.shape[-2] * math.prod(t.shape[:-2])
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=g)


def init_like_jax(net: nn.Module, seed: int = 0) -> nn.Module:
    """Draw ``net``'s weights from ``seed`` (in place; returns ``net``)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        if isinstance(net, GTCRN):
            return _init_gtcrn(net, seed)
        for mod in net.modules():
            for name, p in list(mod.named_parameters(recurse=False)) + list(
                    mod.named_buffers(recurse=False)):
                _init_leaf(mod, name, p, g)
    if hasattr(net, "fold_k1"):
        net.fold_k1()
    return net


def _init_leaf(mod: nn.Module, name: str, p: torch.Tensor,
               g: torch.Generator) -> None:
    if name in mod._non_persistent_buffers_set or not p.is_floating_point():
        return
    if isinstance(mod, nn.GRU):
        bound = 1.0 / math.sqrt(mod.hidden_size)
        p.copy_((2.0 * torch.rand(p.shape, generator=g) - 1.0) * bound)
    elif isinstance(mod, nn.LayerNorm):
        p.fill_(1.0 if name == "weight" else 0.0)
    elif name in _ONES or name.endswith("_g") or (
            isinstance(mod, BatchNorm) and name == "weight"):
        p.fill_(1.0)
    elif name in _ZEROS or (isinstance(mod, BatchNorm) and name == "bias"):
        p.zero_()
    elif name == "pos_emb":
        p.copy_(0.02 * torch.randn(p.shape, generator=g))
    elif p.ndim >= 2:
        he_normal_(p, g)
        if (isinstance(mod, DialogDemixer) and name.startswith("dec")
                and name.endswith("_w") and "glu" not in name):
            p.mul_(0.1)
    else:
        p.zero_()


def _init_gtcrn(net: GTCRN, seed: int) -> GTCRN:
    # the modules' own reset_parameters draw from the global generator:
    # seeded here, and the caller's state restored after
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for mod in net.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters()
    for mod in net.modules():
        if isinstance(mod, BatchNorm):
            for name, t in list(mod.named_parameters(recurse=False)) + list(
                    mod.named_buffers(recurse=False)):
                t.fill_(1.0 if name in ("weight", "running_var") else 0.0)
    fb = torch.from_numpy(erb_filterbank())
    net.erb.erb_fc.weight.copy_(fb)
    net.erb.ierb_fc.weight.copy_(fb.T)
    return net

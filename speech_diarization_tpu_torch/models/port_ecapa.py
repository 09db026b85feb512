"""SpeechBrain ECAPA-TDNN checkpoint -> the port's :class:`EcapaTdnn`.

The port's copy of the JAX package's ``models/port_ecapa.py``: the
declarative key map between the state_dict of SpeechBrain's
``speechbrain.lobes.models.ECAPA_TDNN.ECAPA_TDNN`` (a bundle's
``embedding_model.ckpt``) and the port's ``EcapaTdnn.state_dict()``, and the
shape manifest of that state_dict derived from the architecture, so the map
is testable without the artifact.

SpeechBrain schema (state_dict key -> role):
  blocks.0.{conv.conv,norm.norm}            initial TDNNBlock (stem)
  blocks.{1..3}.tdnn1 / res2net_block.blocks.{j} / tdnn2 / se_block
                                            SE-Res2Net blocks
  mfa.{conv.conv,norm.norm}                 multi-layer feature aggregation
  asp.tdnn.{conv.conv,norm.norm}, asp.conv.conv
                                            attentive statistics pooling
  asp_bn.norm                               post-pooling BatchNorm
  fc.conv                                   final projection

As in the JAX package the checkpoint loads onto the net it is given, by
default the constructor's (80 mels, C 512, scale 8, SE 128, attention 128,
dilations 2/3/4): no width is inferred from the file.
"""
from __future__ import annotations

from pathlib import Path
from typing import Mapping

import torch

from .ecapa import EcapaTdnn
from .port import check_schema, float32_arrays, torch_checkpoint

# the port's ConvBN fields <- SpeechBrain TDNNBlock suffixes
_CONV_BN_FIELDS = {
    "w": "conv.conv.weight",
    "b": "conv.conv.bias",
    "bn_gamma": "norm.norm.weight",
    "bn_beta": "norm.norm.bias",
    "bn_mean": "norm.norm.running_mean",
    "bn_var": "norm.norm.running_var",
}
_BN_FIELDS = {
    "gamma": "norm.weight",
    "beta": "norm.bias",
    "mean": "norm.running_mean",
    "var": "norm.running_var",
}


def ecapa_speechbrain_key_map(net: EcapaTdnn | None = None) -> dict[str, str]:
    """SpeechBrain state_dict key -> the port's ``EcapaTdnn`` state_dict key."""
    net = net or EcapaTdnn()
    m: dict[str, str] = {}

    def conv_bn(prefix: str, ours: str) -> None:
        for field, theirs in _CONV_BN_FIELDS.items():
            m[f"{prefix}.{theirs}"] = f"{ours}.{field}"

    conv_bn("blocks.0", "stem")
    for i in range(len(net.dilations)):
        t = i + 1
        conv_bn(f"blocks.{t}.tdnn1", f"block.{i}.conv1")
        for j in range(net.scale - 1):
            conv_bn(f"blocks.{t}.res2net_block.blocks.{j}", f"block.{i}.res2.{j}")
        conv_bn(f"blocks.{t}.tdnn2", f"block.{i}.conv2")
        for n in (1, 2):
            m[f"blocks.{t}.se_block.conv{n}.conv.weight"] = f"block.{i}.se_w{n}"
            m[f"blocks.{t}.se_block.conv{n}.conv.bias"] = f"block.{i}.se_b{n}"
    conv_bn("mfa", "mfa")
    m["asp.tdnn.conv.conv.weight"] = "att_w1"
    m["asp.tdnn.conv.conv.bias"] = "att_b1"
    for field, theirs in _BN_FIELDS.items():
        m[f"asp.tdnn.norm.{theirs}"] = f"att_bn.{field}"
        m[f"asp_bn.{theirs}"] = f"post_bn.{field}"
    m["asp.conv.conv.weight"] = "att_w2"
    m["asp.conv.conv.bias"] = "att_b2"
    m["fc.conv.weight"] = "fc_w"
    m["fc.conv.bias"] = "fc_b"
    return m


def ecapa_torch_manifest(net: EcapaTdnn | None = None) -> dict[str, tuple[int, ...]]:
    """The SpeechBrain state_dict's shapes for ``net``'s architecture (the
    contract the artifact must meet and the key map must cover)."""
    net = net or EcapaTdnn()
    ours = net.state_dict()
    return {k: tuple(ours[v].shape)
            for k, v in ecapa_speechbrain_key_map(net).items()}


def load_ecapa_speechbrain(src: str | Path | Mapping, net: EcapaTdnn | None = None,
                           strict: bool = True) -> EcapaTdnn:
    """A SpeechBrain ECAPA ``embedding_model`` state_dict (or the path of an
    ``embedding_model.ckpt``, read as :func:`~.port.torch_checkpoint`
    reads it) into ``net``.  Conv weights keep torch's [out, in, k] layout;
    BatchNorm weight / bias / running stats become gamma / beta / mean /
    var.  ``strict``: keys and shapes checked against
    :func:`ecapa_torch_manifest` (``ValueError``)."""
    net = net or EcapaTdnn()
    if not isinstance(src, Mapping):
        src = torch_checkpoint(src)
    sd = float32_arrays(src)
    key_map = ecapa_speechbrain_key_map(net)
    if strict:
        check_schema(sd, ecapa_torch_manifest(net))
    net.load_state_dict({key_map[k]: torch.from_numpy(v) for k, v in sd.items()
                         if k in key_map}, strict=strict)
    return net.eval()

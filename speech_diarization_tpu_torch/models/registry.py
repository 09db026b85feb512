"""Speaker-encoder selector: the JAX package's ``models/registry.py``.

One factory builds any backend from any checkpoint format the JAX registry
reads, branch for branch:

  ecapa       a ``.npz`` of the synthetic trainer (architecture in its
              ``__meta__`` sidecar) or a SpeechBrain ``embedding_model.ckpt``
              (``models/port_ecapa.py``); with no weights, the first shipped
              of ``ENCODER_PREFERENCE``, else random with a loud warning.
  eres2netv2  a 3D-Speaker torch checkpoint or ONNX (``models/eres2netv2.py``).
  campp       a 3D-Speaker torch checkpoint or ONNX (``models/campp.py``).

A model holds its weights (an ``nn.Module``), so :func:`make_encoder_model`
returns the model where the JAX function returns ``(model, params)``.
Random weights come from a ``torch.Generator`` seeded by ``seed``; they
cannot equal ``jax.random``'s draw for the same seed.
:func:`seeded_state_dict` is the one draw both packages can share: numpy
arrays from a manifest, which each package's loader reads.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..utils.logging import get_logger

log = get_logger("registry")

BACKENDS = ("ecapa", "eres2netv2", "campp")

# 1-D state_dict entries that start at one (BatchNorm gains and variances)
_ONES = ("weight", "running_var", "gamma", "bn_gamma", "var", "bn_var")


def seeded_init(net: torch.nn.Module, seed: int = 0) -> torch.nn.Module:
    """Random weights in the JAX ``init``'s scheme from a seeded
    ``torch.Generator``: He-normal convolutions and linears, BatchNorm gains
    and variances one, biases and means zero."""
    g = torch.Generator().manual_seed(seed)
    state = {}
    for name, v in net.state_dict().items():
        if v.ndim >= 2:
            fan_in = int(np.prod(v.shape[1:]))
            state[name] = torch.randn(v.shape, generator=g) * (2.0 / fan_in) ** 0.5
        elif name.rsplit(".", 1)[-1] in _ONES:
            state[name] = torch.ones(v.shape)
        else:
            state[name] = torch.zeros(v.shape)
    net.load_state_dict(state)
    return net.eval()


def seeded_state_dict(manifest: dict[str, tuple[int, ...]],
                      seed: int = 0) -> dict[str, np.ndarray]:
    """A float32 state_dict for ``manifest`` (key -> shape, torch names)
    from ``numpy.random.default_rng(seed)``, key by key in sorted order, so
    any package's manifest of the same net gives the same arrays:
    convolution and linear weights N(0, 1/fan_in); BatchNorm running means
    N(0, 0.1^2), running variances U(0.5, 1.5), gains U(0.8, 1.2); biases
    N(0, 0.05^2).  BatchNorm entries are those with a ``running_mean``
    sibling.  The weights' variance is half He-normal's: the running
    statistics do not normalize the activations, and with He-normal
    weights ERes2NetV2's eval-mode residual stacks grow by orders of
    magnitude, until its AFF gates turn float32 rounding into a different
    embedding and two summation orders disagree.

    The published enhancer graphs' leaves start near their JAX ``init``
    values: a one-dimensional ``weight`` outside a BatchNorm with a
    ``bias`` sibling (instance, group and layer norms) U(0.8, 1.2), without
    one (PReLU) U(0.2, 0.3); Zipformer ``bypass_scale`` U(0.4, 0.6),
    LayerScale ``scale`` U(5e-4, 1.5e-3), the learnable sigmoid's
    ``slope`` U(0.8, 1.2).  The speaker encoders' manifests have none of
    these leaves, so their draws are unchanged."""
    rng = np.random.default_rng(seed)
    bn = {k.rsplit(".", 1)[0] for k in manifest if k.endswith("running_mean")}
    out = {}
    for k in sorted(manifest):
        shape = tuple(manifest[k])
        prefix, leaf = k.rsplit(".", 1)
        if leaf == "running_mean":
            a = rng.normal(0.0, 0.1, shape)
        elif leaf == "running_var":
            a = rng.uniform(0.5, 1.5, shape)
        elif prefix in bn and leaf == "weight":
            a = rng.uniform(0.8, 1.2, shape)
        elif leaf == "weight" and len(shape) == 1:
            a = (rng.uniform(0.8, 1.2, shape) if f"{prefix}.bias" in manifest
                 else rng.uniform(0.2, 0.3, shape))
        elif leaf == "bypass_scale":
            a = rng.uniform(0.4, 0.6, shape)
        elif leaf == "scale":
            a = rng.uniform(5e-4, 1.5e-3, shape)
        elif leaf == "slope":
            a = rng.uniform(0.8, 1.2, shape)
        elif len(shape) >= 2:
            a = rng.normal(0.0, (1.0 / np.prod(shape[1:])) ** 0.5, shape)
        else:
            a = rng.normal(0.0, 0.05, shape)
        out[k] = a.astype(np.float32)
    return out


def _make_ecapa(weights, sample_rate: int, seed: int, dtype):
    from .ecapa import EcapaModel, EcapaTdnn
    from .port import _DTYPES

    if weights is None:
        from ..utils.weights import ENCODER_PREFERENCE, prefer_weights

        weights = prefer_weights(ENCODER_PREFERENCE)
    if weights is not None and str(weights).endswith(".npz"):
        from .port import load_speaker_encoder

        log.info("ecapa: loading %s", weights)
        model = load_speaker_encoder(weights, dtype=dtype)
    elif weights is not None:  # SpeechBrain embedding_model.ckpt
        from .port_ecapa import load_ecapa_speechbrain

        log.info("ecapa: loading SpeechBrain checkpoint %s", weights)
        model = EcapaModel(load_ecapa_speechbrain(
            weights, EcapaTdnn(dtype=_DTYPES[dtype])))
    else:
        log.warning("ecapa: no weights given and none shipped — RANDOM weights; "
                    "speaker labels will be meaningless")
        model = EcapaModel(seeded_init(EcapaTdnn(dtype=_DTYPES[dtype]), seed))
    model.sample_rate = sample_rate
    return model


def make_encoder_model(backend: str = "ecapa", weights: str | Path | None = None,
                       sample_rate: int = 16000, seed: int = 0,
                       dtype=None) -> torch.nn.Module:
    """The encoder of ``backend`` with its weights, on the CPU: pass it to
    ``DiarizationPipeline(encoder=...)``, which moves it to its device and
    picks the grid from it (a streaming-trained ECAPA runs the streamed
    ingest, any other encoder the windowed grid).  ``dtype`` (None =
    float32, or ``torch.bfloat16``) is ECAPA's trunk dtype; ERes2NetV2 and
    CAM++ run float32, as the JAX registry builds them."""
    if backend == "ecapa":
        return _make_ecapa(weights, sample_rate, seed, dtype)
    if backend not in BACKENDS:
        raise ValueError(f"unknown encoder backend {backend!r}; choose from {BACKENDS}")
    if dtype not in (None, torch.float32):
        raise ValueError(f"{backend} runs float32 only, as in the JAX package")
    if backend == "eres2netv2":
        from .eres2netv2 import ERes2NetV2Model, load_eres2netv2

        model = ERes2NetV2Model(sample_rate=sample_rate)
        if weights is not None:
            load_eres2netv2(weights, model.net)
        else:
            log.warning("eres2netv2: no checkpoint — RANDOM weights; port one "
                        "via models/eres2netv2.load_eres2netv2")
            seeded_init(model.net, seed)
    else:
        from .campp import CamPlusPlusModel, load_campp

        model = CamPlusPlusModel(sample_rate=sample_rate)
        if weights is not None:
            load_campp(weights, model.net)
        else:
            log.warning("campp: no checkpoint — RANDOM weights; port one via "
                        "models/campp.load_campp")
            seeded_init(model.net, seed)
    return model.eval()


def make_encoder(backend: str = "ecapa", weights: str | Path | None = None,
                 sample_rate: int = 16000, seed: int = 0,
                 device: str | torch.device | None = None) -> tuple[Callable, int]:
    """``(encode_fn, emb_dim)``: ``encode_fn(wavs [B, T]) -> [B, D]`` on
    ``device`` (None: the card; raises without CUDA)."""
    from ..utils.device import disable_tf32, resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        disable_tf32()
    model = make_encoder_model(backend, weights, sample_rate, seed).to(dev)

    def encode_fn(wavs) -> torch.Tensor:
        with torch.inference_mode():
            return model.encode_batch(torch.as_tensor(wavs, dtype=torch.float32)
                                      .to(dev))

    return encode_fn, model.net.emb_dim

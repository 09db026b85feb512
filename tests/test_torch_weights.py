"""The PyTorch port's weight loaders against the JAX package's loaders.

Shipped checkpoints must load to exactly the arrays the JAX loaders give
(float16 storage upcast to float32 by both), and a net initialised in JAX
must carry across through ``params_from_numpy`` bit for bit.  Tolerance:
exact equality (the arrays are copied, not recomputed).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.models.ecapa import EcapaTdnn as JEcapaTdnn
from speech_diarization_tpu.models.segmentation import SegNet as JSegNet
from speech_diarization_tpu.models.vad import VadConvNet as JVadConvNet
from speech_diarization_tpu.train.recipes import _flatten
from speech_diarization_tpu.train.recipes import load_segmentation as jload_seg
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu_torch.models.port import (
    load_segmentation,
    load_speaker_encoder,
    load_vad,
    params_from_numpy,
)

torch.set_num_threads(2)
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _state_of(module) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def _port_key(flat_key: str) -> str:
    import re

    return re.sub(r"^block(\d+)/", r"block.\1/", flat_key).replace("/", ".")


def _assert_same(jax_flat: dict, port_state: dict) -> None:
    jax_flat = {_port_key(k): np.asarray(v) for k, v in jax_flat.items()
                if not k.startswith("classifier/")}
    assert set(jax_flat) == set(port_state)
    for k, v in jax_flat.items():
        assert port_state[k].dtype == np.float32, k
        np.testing.assert_array_equal(port_state[k], v, err_msg=k)


def test_vad_checkpoint_equals_jax_loader():
    _, jp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    model = load_vad(WEIGHTS / "vad_conv_mc.npz")
    _assert_same(_flatten(jp), _state_of(model.net))
    assert model.net.dilations == (1, 2, 4, 8, 16, 32)
    assert model.net.n_mels == 40 and model.net.channels == 96


def test_ecapa_checkpoint_equals_jax_loader():
    jm, jp = jload_enc(WEIGHTS / "ecapa_robust_stream.npz")
    model = load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz")
    _assert_same(_flatten(jp), _state_of(model.net))
    assert model.streaming_trained is jm.streaming_trained is True
    assert model.refine_sub_cos == jm.refine_sub_cos == 0.7
    net = model.net
    assert (net.channels, net.cat_channels, net.att_channels, net.emb_dim) == (
        256, 768, 64, 128)


def test_ecapa_bf16_loader_keeps_float32_weights():
    model = load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz",
                                 dtype=torch.bfloat16)
    assert model.net.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.net.parameters())


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_initialised_ecapa_carries_across(seed):
    cfg = {"n_mels": 8, "channels": 16, "scale": 4, "se_channels": 8,
           "att_channels": 8, "emb_dim": 12, "dilations": [2, 3, 4]}
    net = JEcapaTdnn(**{**cfg, "dilations": (2, 3, 4)})
    params = net.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    model = params_from_numpy(flat, {"net": cfg, "streaming_stats": True})
    _assert_same(flat, _state_of(model.net))
    # the carried net computes what the JAX net computes
    feats = np.random.default_rng(seed).standard_normal((1, 50, 8)).astype(np.float32)
    ref = np.asarray(net.trunk(params, jnp.asarray(feats), se_win=21))
    out = model.net.trunk(torch.from_numpy(feats), se_win=21).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


def test_jax_initialised_vad_carries_across():
    cfg = {"n_mels": 12, "channels": 16, "dilations": [1, 2, 4], "kernel": 3}
    net = JVadConvNet(n_mels=12, channels=16, dilations=(1, 2, 4))
    params = net.init(jax.random.PRNGKey(3))
    flat = {k: np.asarray(v) for k, v in params.items()}
    model = params_from_numpy(flat, {"arch": "conv", "net": cfg})
    _assert_same(flat, _state_of(model.net))
    feats = np.random.default_rng(3).standard_normal((1, 40, 12)).astype(np.float32)
    ref = np.asarray(net.apply(params, jnp.asarray(feats)))
    out = model.net(torch.from_numpy(feats)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_params_from_numpy_rejects_missing_and_unknown_arrays():
    cfg = {"n_mels": 12, "channels": 16, "dilations": [1, 2], "kernel": 3}
    params = JVadConvNet(n_mels=12, channels=16, dilations=(1, 2)).init(
        jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in params.items()}
    missing = dict(flat)
    missing.pop("stem_w")
    with pytest.raises(RuntimeError):
        params_from_numpy(missing, {"arch": "conv", "net": cfg})
    with pytest.raises(RuntimeError):
        params_from_numpy({**flat, "extra_w": flat["stem_w"]},
                          {"arch": "conv", "net": cfg})


def test_params_from_numpy_upcasts_float16():
    cfg = {"n_mels": 12, "channels": 16, "dilations": [1], "kernel": 3}
    params = JVadConvNet(n_mels=12, channels=16, dilations=(1,)).init(
        jax.random.PRNGKey(0))
    flat = {k: np.asarray(v).astype(np.float16) for k, v in params.items()}
    model = params_from_numpy(flat, {"arch": "conv", "net": cfg})
    for k, v in _state_of(model.net).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, flat[k].astype(np.float32))


SEG_CFG = {"n_mels": 12, "channels": 16, "hidden": 16, "n_speakers": 3,
           "powerset": True, "ds": 3, "arch": "xf", "n_xf": 2, "n_heads": 4,
           "max_frames": 101}


@pytest.mark.parametrize("name", ["segmentation_conv.npz", "segmentation_xf.npz"])
def test_segmentation_checkpoint_equals_jax_loader(name):
    jm, jp = jload_seg(WEIGHTS / name)
    model = load_segmentation(WEIGHTS / name)
    _assert_same({k: np.asarray(v) for k, v in jp.items()}, _state_of(model.net))
    net = model.net
    assert (net.arch, net.powerset, net.n_speakers, net.ds, net.n_xf, net.n_heads
            ) == ("xf", True, 3, jm.net.ds, jm.net.n_xf, jm.net.n_heads)
    assert net.n_out == 8 and net.memb.shape == (8, 3)
    np.testing.assert_array_equal(net.membership(), jm.net.membership())


def test_segmentation_conv_is_the_full_width_detector():
    net = load_segmentation(WEIGHTS / "segmentation_conv.npz").net
    assert (net.n_mels, net.channels, net.hidden, net.ds, net.n_xf) == (
        40, 128, 128, 3, 4)
    assert net.pos_emb.shape == (169, 256) and net.xf1_ff1_w.shape == (256, 1024)


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_initialised_segnet_carries_across(seed):
    params = JSegNet(**SEG_CFG).init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in params.items()}
    model = params_from_numpy(flat, {"net": SEG_CFG})     # kind inferred
    _assert_same(flat, _state_of(model.net))
    assert "memb" not in model.net.state_dict()


def test_segmentation_loader_is_strict_and_upcasts():
    params = JSegNet(**SEG_CFG).init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in params.items()}
    missing = dict(flat)
    missing.pop("xf2_qkv_w")
    with pytest.raises(RuntimeError):
        params_from_numpy(missing, {"net": SEG_CFG}, kind="segmentation")
    with pytest.raises(RuntimeError):
        params_from_numpy({**flat, "xf3_qkv_w": flat["xf2_qkv_w"]},
                          {"net": SEG_CFG}, kind="segmentation")
    half = {k: v.astype(np.float16) for k, v in flat.items()}
    model = params_from_numpy(half, {"net": SEG_CFG}, kind="segmentation")
    for k, v in _state_of(model.net).items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, half[k].astype(np.float32))


@pytest.mark.parametrize("meta", [{}, {"net": {**SEG_CFG, "arch": "gru"}}])
def test_recurrent_segnet_is_refused(meta):
    """The recurrent nets, once refused here, load: no meta is the 96/96
    sigmoid-head net (as the JAX loader reads it), a ``gru`` meta its own
    widths, each from the JAX init's flat keys (``gru{i}_f`` / ``gru{i}_b``
    onto one bidirectional ``nn.GRU``).  A dict without those weights is
    refused by the strict load."""
    cfg = meta.get("net", {})
    flat = {k: np.asarray(v) for k, v in _flatten(
        JSegNet(**cfg).init(jax.random.PRNGKey(2))).items()}
    model = params_from_numpy(flat, meta, kind="segmentation")
    net = model.net
    assert net.arch == "gru" and net.powerset == cfg.get("powerset", False)
    np.testing.assert_array_equal(net.gru2.weight_hh_l0_reverse.numpy(),
                                  flat["gru2_b/w_hh"])
    with pytest.raises(RuntimeError, match="gru1.weight_ih_l0"):
        params_from_numpy({}, meta, kind="segmentation")

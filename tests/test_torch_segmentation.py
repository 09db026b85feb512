"""The PyTorch port's overlap detector (``models/segmentation.py``) against
the JAX package's ``SegNet`` / ``SegmentationModel``.

Inputs come from numpy seeds.  At a small width (2 transformer layers,
dm 32) a JAX-initialised net is carried across by ``params_from_numpy``:
logits atol 1e-4, activities atol 1e-5.  At full width on the shipped
``segmentation_conv.npz``: logits atol 1e-3 and at least 99.9 % equal hard
slot decisions on four 5 s windows of a conversation with overlapped speech
(the output is an argmax over 8 logits and may flip on a near-tie).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.models.layers import layer_norm_apply as jlayer_norm
from speech_diarization_tpu.models.layers import conv1d_torch as jconv1d
from speech_diarization_tpu.models.segmentation import SegmentationModel as JSegModel
from speech_diarization_tpu.models.segmentation import SegNet as JSegNet
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu.train.recipes import load_segmentation as jload_seg
from speech_diarization_tpu_torch.models.layers import conv1d_torch, layer_norm_apply
from speech_diarization_tpu_torch.models.port import (
    load_segmentation,
    params_from_numpy,
)
from speech_diarization_tpu_torch.models.segmentation import SegNet

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"
SMALL = {"n_mels": 12, "channels": 16, "hidden": 16, "n_speakers": 3,
         "powerset": True, "ds": 3, "arch": "xf", "n_xf": 2, "n_heads": 4,
         "max_frames": 101}


def _small(seed: int, **over):
    cfg = {**SMALL, **over}
    jnet = JSegNet(**cfg)
    params = jnet.init(jax.random.PRNGKey(seed))
    # biases and norms are initialised to 0 / 1: perturb them so every
    # parameter takes part in the comparison
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) + (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
              if v.ndim == 1 else np.asarray(v) for k, v in params.items()}
    model = params_from_numpy(params, {"net": cfg}, kind="segmentation").eval()
    return jnet, {k: jnp.asarray(v) for k, v in params.items()}, model


@pytest.mark.parametrize("stride,dilation,pad", [(1, 1, 0), (3, 1, 3), (1, 2, 2),
                                                 (2, 3, 1)])
def test_conv1d_stride_and_dilation_match_jax(stride, dilation, pad):
    rng = np.random.default_rng(stride + 10 * dilation)
    x = rng.standard_normal((2, 6, 50)).astype(np.float32)
    w = rng.standard_normal((5, 6, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = np.asarray(jconv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=stride, padding=pad, dilation=dilation))
    out = conv1d_torch(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                       stride=stride, padding=pad, dilation=dilation).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("eps", [1e-8, 1e-5])
def test_layer_norm_matches_jax(eps):
    rng = np.random.default_rng(3)
    x = (3.0 * rng.standard_normal((2, 7, 32)) + 1.0).astype(np.float32)
    g = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    ref = np.asarray(jlayer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), eps))
    ref2 = np.asarray(JSegNet._ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    out = layer_norm_apply(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b), eps).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)
    if eps == 1e-5:
        np.testing.assert_allclose(SegNet._ln(torch.from_numpy(x), torch.from_numpy(g),
                                              torch.from_numpy(b)).numpy(),
                                   ref2, atol=1e-5)


@pytest.mark.parametrize("seed,frames,n_fc", [(0, 101, 0), (1, 100, 0), (2, 37, 1)])
def test_small_segnet_logits_match_jax(seed, frames, n_fc):
    jnet, params, model = _small(seed, n_fc=n_fc)
    feats = np.random.default_rng(seed).standard_normal((3, frames, 12)
                                                        ).astype(np.float32)
    ref = np.asarray(jnet.logits(params, jnp.asarray(feats)))
    with torch.inference_mode():
        out = model.net.logits(torch.from_numpy(feats)).numpy()
    assert out.shape == ref.shape == (3, frames, 8)
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("powerset", [True, False])
def test_small_segnet_activities_and_hard_decisions_match_jax(powerset):
    jnet, params, model = _small(4, powerset=powerset)
    feats = np.random.default_rng(4).standard_normal((2, 64, 12)).astype(np.float32)
    with torch.inference_mode():
        soft = model.net(torch.from_numpy(feats)).numpy()
        hard = model.net.apply_hard(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(soft, np.asarray(jnet.apply(params, jnp.asarray(feats))),
                               atol=1e-5)
    jhard = np.asarray(jnet.apply_hard(params, jnp.asarray(feats)))
    assert hard.shape == jhard.shape == (2, 64, 3)
    assert (hard == jhard).mean() >= 0.999
    assert set(np.unique(hard)) <= {0.0, 1.0}


def test_membership_and_tie_break_match_jax():
    jnet, _, model = _small(0)
    np.testing.assert_array_equal(model.net.membership(), jnet.membership())
    # a tie resolves to the first class in both
    logits = np.zeros((1, 2, 8), np.float32)
    logits[0, 1, [3, 5]] = 1.0
    hard = model.net.hard_from_logits(torch.from_numpy(logits)).numpy()
    ref = jnet.membership()[np.asarray(jnp.argmax(jnp.asarray(logits), -1))]
    np.testing.assert_array_equal(hard, ref)


def test_more_frames_than_learned_positions_raise():
    _, _, model = _small(0)
    with pytest.raises(ValueError, match="learned positions"):
        model.net.logits(torch.zeros(1, 120, 12))


@pytest.mark.parametrize("arch,ds", [("gru", 1), ("gru", 3)])
def test_recurrent_branches_are_refused(arch, ds):
    """The recurrent branches, once refused here, build with the
    checkpoint's BiGRU layout (one bidirectional ``nn.GRU`` per
    ``gru{i}_f`` / ``gru{i}_b`` pair; their parity with the JAX package is
    in ``test_torch_segengine.py``); an unknown arch is refused."""
    net = SegNet(arch=arch, ds=ds, channels=16, hidden=12)
    assert net.gru2.bidirectional and net.gru2.input_size == 24
    assert ("ds_w" in dict(net.named_parameters())) == (ds > 1)
    with torch.inference_mode():
        assert net.logits(torch.zeros(2, 50, 40)).shape == (2, 50, 3)
    with pytest.raises(ValueError, match="unknown SegNet arch"):
        SegNet(arch="lstm")


def test_small_model_waveform_wrapper_matches_jax():
    """``_feats`` + net on waveforms: a batch, and a single waveform."""
    jnet, params, model = _small(5)
    jmodel = JSegModel(net=jnet)
    y = (0.2 * np.random.default_rng(5).standard_normal((3, 8000))).astype(np.float32)
    with torch.inference_mode():
        feats = model._feats(torch.from_numpy(y)).numpy()
        logits = model.head_logits(torch.from_numpy(y)).numpy()
        one = model.activities(torch.from_numpy(y[0])).numpy()
    np.testing.assert_allclose(feats, np.asarray(jmodel._feats(jnp.asarray(y))),
                               atol=2e-3)
    np.testing.assert_allclose(
        logits, np.asarray(jmodel.head_logits(params, jnp.asarray(y))), atol=1e-3)
    np.testing.assert_allclose(
        one, np.asarray(jmodel.activities(params, jnp.asarray(y[0]))), atol=1e-4)


@pytest.fixture(scope="module")
def windows():
    w, _ = make_conversation_heldout(np.random.default_rng(4000), 12.5,
                                     n_speakers=3, sr=SR, overlap_frac=0.3)
    return np.stack([w[i * 40000:i * 40000 + 80000] for i in range(4)])


def test_full_width_detector_matches_jax_on_the_shipped_checkpoint(windows):
    jmodel, jparams = jload_seg(WEIGHTS / "segmentation_conv.npz")
    model = load_segmentation(WEIGHTS / "segmentation_conv.npz").eval()
    jl = np.asarray(jmodel.head_logits(jparams, jnp.asarray(windows)))
    jh = np.asarray(jmodel.hard_activities(jparams, jnp.asarray(windows)))
    with torch.inference_mode():
        tl = model.head_logits(torch.from_numpy(windows)).numpy()
        th = model.hard_activities(torch.from_numpy(windows)).numpy()
    assert tl.shape == jl.shape == (4, 501, 8)
    np.testing.assert_allclose(tl, jl, atol=1e-3)
    assert th.shape == jh.shape == (4, 501, 3)
    assert (th == jh).mean() >= 0.999
    # the file has overlapped speech and the detector sees it
    assert (th.sum(-1) >= 2).mean() > 0.02


def test_full_width_detector_single_waveform_matches_batch(windows):
    model = load_segmentation(WEIGHTS / "segmentation_conv.npz").eval()
    with torch.inference_mode():
        batch = model.hard_activities(torch.from_numpy(windows[:2])).numpy()
        one = model.hard_activities(torch.from_numpy(windows[1])).numpy()
    assert (one == batch[1]).mean() >= 0.999

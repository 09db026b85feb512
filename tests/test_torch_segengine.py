"""The segmentation engine of the PyTorch port against the JAX package.

Pieces and bars:

* ``merge_same_speaker``, ``adjust_segment_boundaries`` and
  ``filter_short_segments``: exactly equal segments.
* ``cluster_embeddings`` for each method (spectral on the JAX package's
  numpy path, ROADMAP F2; AHC; HDBSCAN; two-stage HDBSCAN): equal labels.
* ``SegNet``'s recurrent branches at small width (``ds`` 1 and 3, one FC
  layer, sigmoid and powerset heads) on seeded JAX weights carried across,
  and the shipped ``segmentation_ow3.npz`` (96/96 BiGRU powerset net) at
  full width on 4 chunks: head logits within 1e-4 (float32 GRUs summed in
  another order), hard decisions equal.
* ``aggregate_chunk_activities`` (with and without the paired hard
  decisions), ``_exclusive_activity`` and ``_masked_segment_embeddings``:
  within 1e-6 (float64 accumulation on both sides, float32 outputs).
* ``segmentation_diarize`` on a 25 s held-out draw with overlapped speech
  (``segmentation_conv.npz`` and the float32 ``ecapa_robust_stream.npz``):
  equal segments (edges within 1e-6 s, labels equal) on the spectral path,
  with AHC, and with the recurrent ``segmentation_ow3.npz``.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster as jcluster
import speech_diarization_tpu.cluster.spectral as jspectral
import speech_diarization_tpu.pipelines.segmentation as jseg
import speech_diarization_tpu.segment.merge as jmerge
import speech_diarization_tpu_torch.cluster as tcluster
import speech_diarization_tpu_torch.pipelines.segmentation as tseg
import speech_diarization_tpu_torch.segment.merge as tmerge
from speech_diarization_tpu.models.segmentation import SegmentationModel as JSegModel
from speech_diarization_tpu.models.segmentation import SegNet as JSegNet
from speech_diarization_tpu.train.heldout import make_conversation_heldout
from speech_diarization_tpu.train.recipes import _flatten
from speech_diarization_tpu.train.recipes import load_segmentation as jload_seg
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.types import SegmentArray as JSegs
from speech_diarization_tpu_torch.models.port import (
    load_segmentation,
    load_speaker_encoder,
    params_from_numpy,
)
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _jax_numpy_spectral(fn):
    saved = jspectral._device_capable
    jspectral._device_capable = lambda: False
    try:
        return fn()
    finally:
        jspectral._device_capable = saved


def _same_segments(t, j) -> None:
    assert len(t) == len(j) > 0
    np.testing.assert_allclose(t.starts, j.starts, atol=1e-6)
    np.testing.assert_allclose(t.ends, j.ends, atol=1e-6)
    np.testing.assert_array_equal(t.spks, j.spks)


def _random_segments(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.0, 60.0, n))
    ends = starts + rng.uniform(0.05, 3.0, n)
    spks = rng.integers(0, 3, n)
    return (starts, ends, spks)


@pytest.mark.parametrize("op", ["merge_same_speaker", "adjust_segment_boundaries",
                                "filter_short_segments"])
def test_merges_match_jax(op):
    args = {"merge_same_speaker": (1.5, 20.0), "adjust_segment_boundaries": (0.04,),
            "filter_short_segments": (0.3,)}[op]
    for seed in range(5):
        s, e, k = _random_segments(seed)
        ref = getattr(jmerge, op)(JSegs(s, e, k), *args)
        out = getattr(tmerge, op)(SegmentArray(s, e, k), *args)
        np.testing.assert_array_equal(out.starts, ref.starts)
        np.testing.assert_array_equal(out.ends, ref.ends)
        np.testing.assert_array_equal(out.spks, ref.spks)


def _blobs(seed: int, n: int = 60, d: int = 16, k: int = 3):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, d))
    x = centers[rng.integers(0, k, n)] + 0.35 * rng.standard_normal((n, d))
    return x.astype(np.float32)


@pytest.mark.parametrize("method,kw", [("spectral", {"max_speakers": 6}),
                                       ("ahc", {"cos_threshold": 0.6}),
                                       ("hdbscan", {"min_cluster_size": 4}),
                                       ("hdbscan2", {"min_cluster_size": 4})])
def test_cluster_embeddings_matches_jax(method, kw):
    for seed in range(3):
        x = _blobs(seed)
        ref = _jax_numpy_spectral(lambda: np.asarray(
            jcluster.cluster_embeddings(x, method=method, **kw)))
        out = tcluster.cluster_embeddings(x, method=method, **kw)
        np.testing.assert_array_equal(np.asarray(out), ref)


def _small_segnet(ds: int, powerset: bool, seed: int = 0):
    cfg = dict(n_mels=40, channels=16, hidden=12, n_speakers=3, powerset=powerset,
               n_gru=2, n_fc=1, ds=ds)
    net = JSegNet(**cfg)
    params = net.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    port = params_from_numpy(flat, {"net": cfg}, kind="segmentation")
    return JSegModel(net), params, port


@pytest.fixture(scope="module")
def overlap25():
    w, truth = make_conversation_heldout(np.random.default_rng(4000), 25.0,
                                         n_speakers=3, sr=SR, overlap_frac=0.3)
    return w.astype(np.float32), truth


@pytest.mark.parametrize("ds", [1, 3])
@pytest.mark.parametrize("powerset", [False, True], ids=["sigmoid", "powerset"])
def test_recurrent_segnet_small_width_matches_jax(overlap25, ds, powerset):
    jm, params, port = _small_segnet(ds, powerset, seed=ds)
    assert port.net.arch == "gru" and port.net.ds == ds
    chunks = np.stack([overlap25[0][i * 20000:i * 20000 + 24000] for i in range(3)])
    ref = np.asarray(jm.head_logits(params, jnp.asarray(chunks)))
    ref_hard = np.asarray(jm.hard_activities(params, jnp.asarray(chunks)))
    with torch.inference_mode():
        out = port.head_logits(torch.from_numpy(chunks)).numpy()
        hard = port.hard_activities(torch.from_numpy(chunks)).numpy()
    assert out.shape == ref.shape == (3, 151, 8 if powerset else 3)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_array_equal(hard, ref_hard)


def test_ow3_full_width_matches_jax_on_four_chunks(overlap25):
    jm, jp = jload_seg(WEIGHTS / "segmentation_ow3.npz")
    port = load_segmentation(WEIGHTS / "segmentation_ow3.npz")
    assert port.net.arch == "gru" and port.net.powerset and port.net.hidden == 96
    chunks = np.stack([overlap25[0][i * 40000:i * 40000 + 80000] for i in range(4)])
    ref = np.asarray(jm.head_logits(jp, jnp.asarray(chunks)))
    ref_hard = np.asarray(jm.hard_activities(jp, jnp.asarray(chunks)))
    with torch.inference_mode():
        out = port.head_logits(torch.from_numpy(chunks)).numpy()
        hard = port.hard_activities(torch.from_numpy(chunks)).numpy()
    assert out.shape == ref.shape == (4, 501, 8)
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_array_equal(hard, ref_hard)


def test_sigmoid_checkpoint_without_meta_loads_as_the_jax_loader_reads_it(overlap25):
    jm, jp = jload_seg(WEIGHTS / "segmentation_synthetic.npz")
    port = load_segmentation(WEIGHTS / "segmentation_synthetic.npz")
    assert not port.net.powerset and port.net.n_out == 3
    chunks = np.stack([overlap25[0][:80000], overlap25[0][80000:160000]])
    ref = np.asarray(jm.activities(jp, jnp.asarray(chunks)))
    fn = tseg.make_seg_activities_fn(port)
    assert fn.dual is False
    out = fn(torch.from_numpy(chunks)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_aggregate_and_exclusive_activity_match_jax():
    rng = np.random.default_rng(3)
    acts = rng.uniform(0.0, 1.0, (6, 50, 3)).astype(np.float32)
    acts[0, :5, 1] = 1.0                  # saturated slot: the clip matters
    hard = (acts > 0.5).astype(np.float32)
    np.testing.assert_allclose(tseg.aggregate_chunk_activities(acts, 12),
                               jseg.aggregate_chunk_activities(acts, 12), atol=1e-6)
    a, b = tseg.aggregate_chunk_activities(acts, 12, hard)
    ja, jb = jseg.aggregate_chunk_activities(acts, 12, hard)
    np.testing.assert_allclose(a, ja, atol=1e-6)
    np.testing.assert_allclose(b, jb, atol=1e-6)
    np.testing.assert_allclose(tseg._exclusive_activity(acts[0]),
                               jseg._exclusive_activity(acts[0]), atol=1e-6)


def test_masked_segment_embeddings_match_jax():
    rng = np.random.default_rng(4)
    win_embs = rng.standard_normal((200, 8)).astype(np.float32)
    ws = np.arange(200) * 0.1
    starts = np.array([0.0, 1.3, 5.0, 7.05, 12.0, 19.5])
    ends = np.array([0.2, 4.0, 5.3, 11.0, 15.5, 20.9])
    f0 = (starts / 0.01).astype(np.int64)
    purs = [rng.uniform(0.0, 1.0, int(round((e - s) / 0.01))) for s, e in zip(starts, ends)]
    purs[3][:] = 0.0                      # a fully overlapped segment
    ref = jseg._masked_segment_embeddings(win_embs, ws, 1.0, JSegs(starts, ends),
                                          purs, f0, 0.01)
    out = tseg._masked_segment_embeddings(win_embs, ws, 1.0, SegmentArray(starts, ends),
                                          purs, f0, 0.01)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.fixture(scope="module")
def encoders():
    je, jp = jload_enc(WEIGHTS / "ecapa_robust_stream.npz")
    return (jax.jit(partial(je.encode_batch, jp)),
            load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz").eval())


@pytest.mark.parametrize("net,method", [("conv", "spectral"), ("conv", "ahc"),
                                        ("ow3", "spectral")])
def test_segmentation_diarize_matches_jax(overlap25, encoders, net, method):
    wave, _ = overlap25
    jenc, tenc = encoders
    jcfg = jseg.SegmentationConfig(cluster_method=method)
    tcfg = tseg.SegmentationConfig(cluster_method=method)
    ref = _jax_numpy_spectral(lambda: jseg.segmentation_diarize(
        wave, SR, jseg.make_seg_activities_fn(*jload_seg(
            WEIGHTS / f"segmentation_{net}.npz")), jenc, jcfg))
    fn = tseg.make_seg_activities_fn(load_segmentation(
        WEIGHTS / f"segmentation_{net}.npz").eval())
    assert fn.dual is True and fn.device.type == "cpu"
    out = tseg.segmentation_diarize(wave, SR, fn, tenc.encode_batch, tcfg)
    _same_segments(out, ref)

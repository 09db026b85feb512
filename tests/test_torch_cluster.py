"""The port's clustering methods, whitening, AS-Norm and JER against the JAX
package on the same seed-made numpy embeddings, and the pipeline with
``--cluster-method ahc|hdbscan|hdbscan2`` and whitening against the JAX
pipeline.

Bars: AHC and the HDBSCAN variants are host numpy and scipy in the port
(its own HDBSCAN, held to scikit-learn's directly as well) and numpy /
scipy / scikit-learn in the JAX package: labels exactly equal.  ``whiten`` and ``asnorm_scores``
are float32 products and an eigendecomposition in another library: atol
1e-4 (whitened rows are unit vectors; AS-Norm scores are z-scores of
order 1), and for a rank-deficient covariance a row cosine > 0.9999.
JER is host numpy: exactly equal.  Pipelines: final segments exactly equal
(same embeddings to ~1e-6, the clustering is exact).
"""
from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import speech_diarization_tpu.cluster as jcluster
import speech_diarization_tpu.config as jc
import speech_diarization_tpu_torch.cluster as tcluster
import speech_diarization_tpu_torch.config as tc
from speech_diarization_tpu.metrics.der import jaccard_error_rate as jjer
from speech_diarization_tpu.pipelines.diarize import DiarizationPipeline as JPipe
from speech_diarization_tpu.train.recipes import load_speaker_encoder as jload_enc
from speech_diarization_tpu.train.recipes import load_vad as jload_vad
from speech_diarization_tpu.train.synthetic import make_conversation
from speech_diarization_tpu.types import SegmentArray as JSegs
from speech_diarization_tpu_torch.metrics.der import jaccard_error_rate
from speech_diarization_tpu_torch.models.port import load_speaker_encoder, load_vad
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
SR = 16000
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _embs(seed: int, n_spk: int = 3, per: int = 12, dim: int = 32,
          spread: float = 0.35) -> np.ndarray:
    """Speaker clusters on the sphere: ``per`` noisy copies of ``n_spk``
    random directions, shuffled."""
    g = np.random.default_rng(seed)
    centers = g.standard_normal((n_spk, dim))
    x = np.concatenate([c + spread * g.standard_normal((per, dim)) for c in centers])
    return x[g.permutation(len(x))].astype(np.float32)


CASES = [(0, 3, 12), (1, 2, 20), (2, 5, 6), (3, 4, 3)]


@pytest.mark.parametrize("seed,n_spk,per", CASES)
@pytest.mark.parametrize("kw", [{}, {"max_speakers": 2}, {"min_speakers": 6},
                                {"cos_threshold": 0.3}],
                         ids=["defaults", "max2", "min6", "cos0.3"])
def test_ahc_labels_equal(seed, n_spk, per, kw):
    e = _embs(seed, n_spk, per)
    np.testing.assert_array_equal(tcluster.ahc_cluster(e, **kw),
                                  jcluster.ahc_cluster(e, **kw))


@pytest.mark.parametrize("seed,n_spk,per", CASES)
@pytest.mark.parametrize("fn", ["hdbscan_cleaned", "hdbscan_two_stage",
                                "hdbscan_cluster"])
def test_hdbscan_labels_equal(seed, n_spk, per, fn):
    e = _embs(seed, n_spk, per)
    np.testing.assert_array_equal(getattr(tcluster, fn)(e),
                                  getattr(jcluster, fn)(e))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("precomputed", [True, False], ids=["cosine", "euclidean"])
@pytest.mark.parametrize("method,single", [("eom", False), ("eom", True),
                                           ("leaf", False)])
def test_hdbscan_labels_equal_scikit_learns(seed, precomputed, method, single):
    """The port's own HDBSCAN (the card's machine has no scikit-learn)
    against ``sklearn.cluster.HDBSCAN`` on the same inputs, ties included
    (seed 0 and 3 round the embeddings to one decimal): equal labels."""
    import warnings

    from sklearn.cluster import HDBSCAN

    from speech_diarization_tpu_torch.cluster.hdbscan import hdbscan_labels

    e = _embs(seed, 2 + seed % 4, 4 + 3 * seed, 8 + 8 * seed).astype(np.float64)
    if seed % 3 == 0:
        e = np.round(e, 1)
    e /= np.linalg.norm(e, axis=1, keepdims=True) + 1e-8
    x = np.clip(1.0 - e @ e.T, 0.0, None) if precomputed else e
    if precomputed:
        np.fill_diagonal(x, 0.0)
    for mcs in (2, 3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            ref = HDBSCAN(min_cluster_size=mcs,
                          metric="precomputed" if precomputed else "euclidean",
                          allow_single_cluster=single,
                          cluster_selection_method=method).fit_predict(x.copy())
        out = hdbscan_labels(x.copy(), mcs, precomputed=precomputed,
                             allow_single_cluster=single,
                             cluster_selection_method=method)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("seed,n,dim", [(0, 40, 16), (1, 9, 32), (2, 200, 64),
                                        (3, 12, 128), (4, 60, 128)])
def test_whiten_matches_jax(seed, n, dim):
    """With more rows than dimensions atol 1e-4.  With fewer (the
    pipeline's case: tens of segments, 128-d embeddings) the covariance is
    rank-deficient and its null directions scale float32 rounding by
    1/sqrt(eps): float32 and float64 runs of either package differ by
    ~1e-3 there, so the bar is each row's cosine to the JAX row > 0.9999."""
    e = _embs(seed, 3, n // 3 + 1, dim)[:n]
    ref = np.asarray(jcluster.whiten(jnp.asarray(e)))
    out = tcluster.whiten(torch.from_numpy(e)).numpy()
    assert out.shape == ref.shape
    if n > dim:
        np.testing.assert_allclose(out, ref, atol=1e-4)
    assert (out * ref).sum(1).min() > 0.9999


@pytest.mark.parametrize("topk", [5, 200])
def test_asnorm_scores_match_jax(topk):
    g = np.random.default_rng(3)
    q, r, c = (g.standard_normal(s).astype(np.float32)
               for s in ((10, 24), (4, 24), (50, 24)))
    ref = np.asarray(jcluster.asnorm_scores(jnp.asarray(q), jnp.asarray(r),
                                            jnp.asarray(c), topk=topk))
    out = tcluster.asnorm_scores(torch.from_numpy(q), torch.from_numpy(r),
                                 torch.from_numpy(c), topk=topk).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("collar", [0.0, 0.25])
def test_jaccard_error_rate_equal(seed, collar):
    g = np.random.default_rng(seed)

    def segs(n, k):
        s = np.sort(g.uniform(0, 50, n))
        return s, s + g.uniform(0.2, 4.0, n), g.integers(0, k, n)

    ref, hyp = segs(20, 3), segs(25, 4 - seed % 2)
    want = jjer(JSegs(*ref), JSegs(*hyp), collar_s=collar)
    got = jaccard_error_rate(SegmentArray(*ref), SegmentArray(*hyp), collar_s=collar)
    assert got == want


def test_all_noise_falls_back_to_one_speaker(monkeypatch):
    pipe = DiarizationPipeline(tc.DiarizationConfig(
        cluster=tc.ClusterConfig(method="hdbscan"),
        enhance=tc.EnhanceConfig(enabled=False)), encoder=torch.nn.Identity(),
        device="cpu")
    monkeypatch.setattr(tcluster, "hdbscan_cleaned",
                        lambda e, **kw: np.full(len(e), -1, np.int32))
    np.testing.assert_array_equal(pipe._cluster(_embs(0)), np.zeros(36, np.int32))


@pytest.fixture(scope="module")
def conversation():
    w, truth = make_conversation(np.random.default_rng(5), 20.0, n_speakers=3,
                                 sr=SR)
    return w.astype(np.float32), truth


@pytest.fixture(scope="module")
def pipes():
    """One pipeline of each package (rescue and enhancement off); the tests
    swap the config, which the host tail reads per call."""
    from functools import partial

    jvad, jvp = jload_vad(WEIGHTS / "vad_conv_mc.npz")
    jpipe = JPipe(_cfg(jc, "spectral", False),
                  encoder=jload_enc(WEIGHTS / "ecapa_robust_stream.npz"),
                  vad_probs_fn=jax.jit(partial(jvad.probs, jvp)))
    tpipe = DiarizationPipeline(
        _cfg(tc, "spectral", False),
        encoder=load_speaker_encoder(WEIGHTS / "ecapa_robust_stream.npz"),
        vad=load_vad(WEIGHTS / "vad_conv_mc.npz"), device="cpu")
    return jpipe, tpipe


def _cfg(mod, method, whiten):
    return mod.DiarizationConfig(
        overlap=mod.OverlapConfig(enabled=False),
        enhance=mod.EnhanceConfig(enabled=False),
        cluster=mod.ClusterConfig(method=method),
        embed=mod.EmbedConfig(whiten=whiten))


@pytest.mark.parametrize("method,whiten", [("ahc", False), ("hdbscan", False),
                                           ("hdbscan2", False),
                                           ("spectral", True)])
def test_pipeline_cluster_methods_match_jax(conversation, pipes, method,
                                            whiten):
    """The streamed pipeline (rescue off, enhancement off) on a 20 s
    draw: the same final segments, labels included."""
    w, _ = conversation
    jpipe, tpipe = pipes
    jpipe.cfg, tpipe.cfg = _cfg(jc, method, whiten), _cfg(tc, method, whiten)
    jres = jpipe((w, SR))
    tres = tpipe(w)
    assert tres.diagnostics["route"] == "streamed"
    assert len(tres.segments) == len(jres.segments) > 0
    np.testing.assert_allclose(tres.segments.starts, jres.segments.starts, atol=1e-6)
    np.testing.assert_allclose(tres.segments.ends, jres.segments.ends, atol=1e-6)
    np.testing.assert_array_equal(tres.segments.spks, jres.segments.spks)

"""The PyTorch port's host tail against the JAX package on identical inputs.

SCD, grid segment embeddings, spectral clustering (the numpy path the JAX
package ran on the TPU, ``_spectral_labels_np``), the window refine, the
merges and the DER metric are host numpy in both packages, so the bar is
exact equality.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from speech_diarization_tpu.cluster import spectral as jspectral
from speech_diarization_tpu.metrics.der import diarization_error_rate as jder
from speech_diarization_tpu.segment.embed import (
    segment_embeddings_from_grid as jseg_embs,
)
from speech_diarization_tpu.segment.embed import window_starts as jwindow_starts
from speech_diarization_tpu.segment.merge import conservative_merge as jcmerge
from speech_diarization_tpu.segment.merge import merge_adjacent as jadj
from speech_diarization_tpu.segment.scd import scd_split as jscd
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.cluster import spectral
from speech_diarization_tpu_torch.metrics.der import diarization_error_rate
from speech_diarization_tpu_torch.segment import (
    conservative_merge,
    merge_adjacent,
    scd_split,
    segment_embeddings_from_grid,
    window_starts,
)
from speech_diarization_tpu_torch.types import SegmentArray

DATA = Path(__file__).resolve().parent / "data" / "segembs_1hr_3spk.npz"
WIN_S, HOP_S = 2.0, 0.1


def _scene(seed: int, dur_s: float = 120.0, n_spk: int = 3, d: int = 32):
    """Speaker turns + a dense window grid whose embeddings are the
    overlap-weighted speaker centroids plus noise."""
    g = np.random.default_rng(seed)
    cents = g.standard_normal((n_spk, d))
    t, turns = 0.0, []
    while t < dur_s - 1.0:
        dur = float(g.uniform(1.5, 9.0))
        gap = float(g.uniform(0.05, 1.2))
        turns.append((t, min(t + dur, dur_s), int(g.integers(n_spk))))
        t += dur + gap
    t_samples = int(dur_s * 16000)
    starts_s = window_starts(t_samples, 16000, WIN_S, HOP_S) / 16000
    embs = np.zeros((len(starts_s), d), np.float32)
    for i, s in enumerate(starts_s):
        for a, b, k in turns:
            ov = min(b, s + WIN_S) - max(a, s)
            if ov > 0:
                embs[i] += ov * cents[k]
    embs += 0.3 * g.standard_normal(embs.shape).astype(np.float32)
    # VAD segments: turns merged across short gaps, speaker unknown
    vad = []
    for a, b, _ in turns:
        if vad and a - vad[-1][1] < 0.3:
            vad[-1][1] = b
        else:
            vad.append([a, b])
    vad = np.asarray(vad)
    return (embs, starts_s, vad, turns, t_samples)


def _both(arr_pairs=None, starts=None, ends=None, spks=None):
    return (SegmentArray(starts, ends, spks), JSegmentArray(starts, ends, spks))


def _eq(a, b):
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.spks, b.spks)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_starts_equal(seed):
    n = 16000 * (30 + 17 * seed) + 123 * seed
    np.testing.assert_array_equal(window_starts(n, 16000, WIN_S, HOP_S),
                                  jwindow_starts(n, 16000, WIN_S, HOP_S))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scd_and_segment_embeddings_equal(seed):
    embs, starts_s, vad, _, _ = _scene(seed)
    p, j = _both(starts=vad[:, 0], ends=vad[:, 1])
    stride = 2
    a = scd_split(p, embs[::stride], starts_s[::stride], WIN_S, HOP_S * stride,
                  z_threshold=1.0, min_speech_s=1.0)
    b = jscd(j, embs[::stride], starts_s[::stride], WIN_S, HOP_S * stride,
             z_threshold=1.0, min_speech_s=1.0)
    _eq(a, b)
    assert len(a) >= len(vad)
    np.testing.assert_array_equal(segment_embeddings_from_grid(embs, starts_s, WIN_S, a),
                                  jseg_embs(embs, starts_s, WIN_S, b))


@pytest.mark.parametrize("n", [64, 300, 1435])
def test_spectral_labels_equal_numpy_path(n):
    embs = np.load(DATA)["embs"].astype(np.float32)[:n]
    n_pad = max(64, int(np.ceil(n / 64)) * 64)
    padded = embs[np.arange(n_pad) % n]
    w = (np.arange(n_pad) < n).astype(np.float32)
    np.testing.assert_array_equal(
        spectral._spectral_labels_np(padded, w, 1, 8),
        jspectral._spectral_labels_np(padded, w, 1, 8))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_spectral_cluster_equals_jax_numpy_path(seed, monkeypatch):
    monkeypatch.setattr(jspectral, "_device_capable", lambda: False)
    embs, *_ = _scene(seed)
    sel = embs[:: 7 + seed]
    np.testing.assert_array_equal(spectral.spectral_cluster(sel, 1, 8),
                                  jspectral.spectral_cluster(sel, 1, 8))


@pytest.mark.parametrize("seed,thr", [(0, 0.7), (1, 0.7), (2, 0.95), (3, 0.95)])
def test_refine_labels_equal(seed, thr):
    embs, starts_s, vad, _, _ = _scene(seed, dur_s=200.0, n_spk=4)
    p, j = _both(starts=vad[:, 0], ends=vad[:, 1])
    segs = scd_split(p, embs, starts_s, WIN_S, HOP_S, 1.0, 1.0)
    jsegs = jscd(j, embs, starts_s, WIN_S, HOP_S, 1.0, 1.0)
    seg_embs = segment_embeddings_from_grid(embs, starts_s, WIN_S, segs)
    # deliberately under-clustered start so the bisection has work to do
    labels = (np.arange(len(segs)) % 2).astype(np.int32)
    a = spectral.refine_labels_by_windows(labels, segs, embs, starts_s, WIN_S,
                                          8, sub_cos_thr=thr, seg_embs=seg_embs)
    b = jspectral.refine_labels_by_windows(labels, jsegs, embs, starts_s, WIN_S,
                                           8, sub_cos_thr=thr, seg_embs=seg_embs)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merges_equal(seed):
    embs, starts_s, vad, _, _ = _scene(seed)
    p, _ = _both(starts=vad[:, 0], ends=vad[:, 1])
    segs = scd_split(p, embs, starts_s, WIN_S, HOP_S, 1.0, 1.0)
    seg_embs = segment_embeddings_from_grid(embs, starts_s, WIN_S, segs)
    labels = spectral.spectral_cluster(seg_embs, 1, 8)
    a, b = _both(starts=segs.starts, ends=segs.ends, spks=labels)
    ma, ea = conservative_merge(a, seg_embs, 0.5, 30.0, 0.8)
    mb, eb = jcmerge(b, seg_embs, 0.5, 30.0, 0.8)
    _eq(ma, mb)
    np.testing.assert_array_equal(ea, eb)
    _eq(merge_adjacent(ma, 0.5), jadj(mb, 0.5))


@pytest.mark.parametrize("seed", [0, 1])
def test_der_equal(seed):
    _, _, _, turns, _ = _scene(seed)
    t = np.asarray(turns)
    g = np.random.default_rng(seed)
    hyp_s = t[:, 0] + g.uniform(-0.2, 0.2, len(t))
    hyp_k = np.where(g.uniform(size=len(t)) < 0.2, (t[:, 2] + 1) % 3, t[:, 2])
    ref_p, ref_j = _both(starts=t[:, 0], ends=t[:, 1], spks=t[:, 2].astype(int))
    hyp_p, hyp_j = _both(starts=hyp_s, ends=t[:, 1], spks=hyp_k.astype(int))
    a = diarization_error_rate(ref_p, hyp_p)
    b = jder(ref_j, hyp_j)
    assert a.der == b.der and a.der > 0


def test_config_schema_matches_jax():
    """The port's config is a field-for-field copy: the same defaults, and a
    config written for the JAX package hydrates the port's."""
    import dataclasses

    from speech_diarization_tpu import config as jconfig
    from speech_diarization_tpu_torch import config as tconfig

    jd = dataclasses.asdict(jconfig.DiarizationConfig())
    assert dataclasses.asdict(tconfig.DiarizationConfig()) == jd
    custom = jconfig.DiarizationConfig(
        overlap=jconfig.OverlapConfig(enabled=False),
        cluster=jconfig.ClusterConfig(max_speakers=5, refine_sub_cos=0.6))
    ported = tconfig.config_from_dict(dataclasses.asdict(custom))
    assert tconfig.config_to_dict(ported) == dataclasses.asdict(custom)
    with pytest.raises(KeyError):
        tconfig.config_from_dict({"vad": {"no_such_field": 1}})

"""The PyTorch port's frame reassignment (``segment/reassign.py``), its
host Viterbi (``ops/viterbi.py``) and the two segment helpers it uses,
against the JAX package on numpy-seeded inputs.  Outputs must be equal: the
transition matrix to 1e-6 (two float32 logarithms), paths, masks, segments
and labels exactly.
"""
from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np
import pytest

from speech_diarization_tpu.ops.segments import labels_to_segments as jlabels_to_segments
from speech_diarization_tpu.ops.segments import segments_to_mask as jsegments_to_mask
from speech_diarization_tpu.ops.viterbi import (
    sticky_transition_logits as jsticky_transition_logits,
)
from speech_diarization_tpu.ops.viterbi import viterbi_decode as jviterbi_decode
from speech_diarization_tpu.segment.reassign import frame_reassign as jframe_reassign
from speech_diarization_tpu.segment.reassign import speaker_centroids as jspeaker_centroids
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.ops.segments import (
    labels_to_segments,
    segments_to_mask,
)
from speech_diarization_tpu_torch.ops.viterbi import (
    sticky_transition_logits,
    viterbi_decode,
)
from speech_diarization_tpu_torch.segment.reassign import (
    frame_reassign,
    speaker_centroids,
)
from speech_diarization_tpu_torch.types import SegmentArray


def _same(a, b):
    assert len(a) == len(b)
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.spks, b.spks)


@pytest.mark.parametrize("k,alpha", [(1, 0.995), (2, 0.995), (3, 0.9), (8, 0.995)])
def test_sticky_transition_logits_match_jax(k, alpha):
    out = sticky_transition_logits(k, alpha)
    ref = np.asarray(jsticky_transition_logits(k, alpha))
    assert out.dtype == np.float32 and out.shape == ref.shape == (k, k)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("seed,t,k", [(0, 1, 3), (1, 2, 2), (2, 50, 3), (3, 400, 8),
                                      (4, 1500, 5)])
def test_viterbi_path_equals_jax(seed, t, k):
    rng = np.random.default_rng(seed)
    # cosine-like scores with a slowly changing best state
    best = np.repeat(rng.integers(0, k, -(-t // 25)), 25)[:t]
    scores = (0.3 * rng.standard_normal((t, k))).astype(np.float32)
    scores[np.arange(t), best] += 0.5
    log_a = np.asarray(jsticky_transition_logits(k, 0.995))
    out = viterbi_decode(scores, log_a)
    ref = np.asarray(jviterbi_decode(jnp.asarray(scores), jnp.asarray(log_a)))
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)


def test_viterbi_ties_resolve_to_the_first_state_and_empty_input():
    log_a = sticky_transition_logits(3, 0.9)
    scores = np.zeros((6, 3), np.float32)
    np.testing.assert_array_equal(
        viterbi_decode(scores, log_a),
        np.asarray(jviterbi_decode(jnp.asarray(scores), jnp.asarray(log_a))))
    assert viterbi_decode(np.zeros((0, 3), np.float32), log_a).shape == (0,)


def test_viterbi_of_a_ten_minute_grid_is_fast_on_the_host():
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((6000, 8)).astype(np.float32)
    t0 = time.perf_counter()
    path = viterbi_decode(scores, sticky_transition_logits(8))
    assert path.shape == (6000,)
    assert time.perf_counter() - t0 < 2.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_helpers_equal(seed):
    rng = np.random.default_rng(seed)
    edges = np.sort(rng.uniform(0.0, 30.0, 16))
    segs = (edges[0::2], edges[1::2])
    np.testing.assert_array_equal(
        segments_to_mask(SegmentArray(*segs), 3000, 0.01),
        jsegments_to_mask(JSegmentArray(*segs), 3000, 0.01))
    labels = np.repeat(rng.integers(-1, 3, 40), rng.integers(1, 9, 40))
    starts = np.arange(len(labels)) * 0.1
    _same(labels_to_segments(starts, labels, starts[-1] + 0.05),
          jlabels_to_segments(starts, labels, starts[-1] + 0.05))
    assert len(labels_to_segments(np.zeros(0), np.zeros(0, int), 0.0)) == 0


def _case(seed, n_spk=3, total_s=40.0, dim=16, noise=0.4):
    rng = np.random.default_rng(seed)
    win_s, hop_s = 2.0, 0.1
    edges = np.sort(rng.uniform(0.0, total_s, 20))
    starts, ends = edges[0::2], edges[1::2]
    spks = rng.integers(0, n_spk, len(starts)).astype(np.int32)
    if seed % 2:
        spks[0] = -1                                  # a noise segment
    cents = rng.standard_normal((n_spk, dim)).astype(np.float32)
    seg_embs = (cents[np.maximum(spks, 0)]
                + 0.2 * rng.standard_normal((len(starts), dim))).astype(np.float32)
    w_starts = np.arange(0.0, total_s - win_s + 1e-9, hop_s)
    centers = w_starts + win_s / 2
    lab = rng.integers(0, n_spk, len(w_starts))
    for s, e, k in zip(starts, ends, spks):
        lab[(centers >= s) & (centers < e)] = max(k, 0)
    win_embs = (cents[lab] + noise * rng.standard_normal((len(w_starts), dim))
                ).astype(np.float32)
    return (starts, ends), (starts, ends, spks), seg_embs, win_embs, w_starts, win_s, total_s


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("hmm", [False, True])
def test_frame_reassign_equals_jax(seed, hmm):
    speech, labeled, seg_embs, win_embs, w_starts, win_s, total_s = _case(seed)
    out = frame_reassign(SegmentArray(*speech), SegmentArray(*labeled), seg_embs,
                         win_embs, w_starts, win_s, total_s, hmm=hmm)
    ref = jframe_reassign(JSegmentArray(*speech), JSegmentArray(*labeled), seg_embs,
                          win_embs, w_starts, win_s, total_s, hmm=hmm)
    assert len(out) > 0
    _same(out, ref)


def test_speaker_centroids_equal_and_exclude_noise():
    _, labeled, seg_embs, *_ = _case(1)
    ids, cents = speaker_centroids(SegmentArray(*labeled), seg_embs)
    jids, jcents = jspeaker_centroids(JSegmentArray(*labeled), seg_embs)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cents, jcents)
    assert -1 not in ids


def test_frame_reassign_passes_empty_inputs_through():
    empty = SegmentArray.from_pairs([])
    out = frame_reassign(empty, empty, np.zeros((0, 4), np.float32),
                         np.zeros((5, 4), np.float32), np.arange(5) * 0.1, 2.0, 3.0)
    assert len(out) == 0

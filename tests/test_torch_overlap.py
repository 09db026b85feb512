"""The PyTorch port's overlap rescue (``segment/overlap.py``) against the
JAX package's, on numpy-seeded inputs and on the cases of the JAX package's
own ``tests/test_overlap.py``.

Host functions (``regions_from_hard_acts``, ``add_overlap_segments``) must
give equal outputs.  ``detect_overlap_regions`` with a stub scorer must
reconstruct the global overlap spans (within 0.02 s, one 10 ms frame on each
side of an edge), and with the shipped full-width detector its regions must
agree with the JAX function's within 0.02 s.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from speech_diarization_tpu.pipelines.segmentation import make_seg_activities_fn
from speech_diarization_tpu.segment.overlap import (
    add_overlap_segments as jadd_overlap_segments,
)
from speech_diarization_tpu.segment.overlap import (
    detect_overlap_regions as jdetect_overlap_regions,
)
from speech_diarization_tpu.segment.overlap import (
    regions_from_hard_acts as jregions_from_hard_acts,
)
from speech_diarization_tpu.train.heldout import (
    make_conversation_heldout as jmake_conversation_heldout,
)
from speech_diarization_tpu.train.recipes import load_segmentation as jload_seg
from speech_diarization_tpu.types import SegmentArray as JSegmentArray
from speech_diarization_tpu_torch.models.port import load_segmentation
from speech_diarization_tpu_torch.segment.overlap import (
    add_overlap_segments,
    detect_overlap_regions,
    make_seg_hard_fn,
    regions_from_hard_acts,
)
from speech_diarization_tpu_torch.train.heldout import make_conversation_heldout
from speech_diarization_tpu_torch.types import SegmentArray

torch.set_num_threads(2)
WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def _same(a, b):
    assert len(a) == len(b)
    np.testing.assert_array_equal(a.starts, b.starts)
    np.testing.assert_array_equal(a.ends, b.ends)
    np.testing.assert_array_equal(a.spks, b.spks)


def _runs_acts(rng, n_chunks, f=501, k=3):
    """Random hard decisions with runs of realistic length (0.1-1.5 s)."""
    acts = np.zeros((n_chunks, f, k), np.float32)
    for c in range(n_chunks):
        for s in range(k):
            pos = 0
            while pos < f:
                n = int(rng.integers(10, 150))
                acts[c, pos:pos + n, s] = float(rng.uniform() < 0.45)
                pos += n
    return acts


@pytest.mark.parametrize("seed,n_chunks,total_s", [
    (0, 1, 4.0), (1, 1, 5.0), (2, 3, 10.0), (3, 9, 25.0), (4, 9, 23.77),
    (5, 23, 60.0), (6, 24, 60.0), (7, 239, 600.0)])
def test_regions_from_hard_acts_equal(seed, n_chunks, total_s):
    acts = _runs_acts(np.random.default_rng(seed), n_chunks)
    _same(regions_from_hard_acts(acts, total_s),
          jregions_from_hard_acts(acts, total_s))


@pytest.mark.parametrize("kw", [dict(min_on_s=0.05, min_gap_s=0.5),
                                dict(min_on_s=1.0, min_gap_s=0.01),
                                dict(chunk_hop_s=1.25), dict(hop_ms=20.0)])
def test_regions_from_hard_acts_equal_under_other_settings(kw):
    acts = _runs_acts(np.random.default_rng(11), 7)
    _same(regions_from_hard_acts(acts, 20.0, **kw),
          jregions_from_hard_acts(acts, 20.0, **kw))


def test_regions_from_hard_acts_without_overlap_is_empty():
    acts = np.zeros((3, 501, 3), np.float32)
    acts[..., 0] = 1.0
    assert len(regions_from_hard_acts(acts, 10.0)) == 0


# ---- detect_overlap_regions with a stub scorer: the cases of
# tests/test_overlap.py::TestDetectOverlapRegions ---------------------------
def _stub(global_two_active, f_per_chunk=501, stride_f=250):
    def fn(chunks):
        n = chunks.shape[0]
        acts = np.zeros((n, f_per_chunk, 2), np.float32)
        acts[:, :, 0] = 1.0
        for c in range(n):
            g = np.arange(c * stride_f, c * stride_f + f_per_chunk)
            g = np.clip(g, 0, len(global_two_active) - 1)
            acts[c, :, 1] = global_two_active[g]
        return acts

    fn.dual = False
    return fn


def test_detect_recovers_global_span():
    sr = 1000
    y = np.zeros(10 * sr, np.float32)
    mask = np.zeros(10 * 100 + 1, np.float32)
    mask[400:550] = 1.0
    regions = detect_overlap_regions(y, sr, _stub(mask), chunk_s=5.0,
                                     chunk_hop_s=2.5, device="cpu")
    assert len(regions) == 1
    assert regions.starts[0] == pytest.approx(4.0, abs=0.02)
    assert regions.ends[0] == pytest.approx(5.5, abs=0.02)
    _same(regions, jdetect_overlap_regions(y, sr, _stub(mask), chunk_s=5.0,
                                           chunk_hop_s=2.5))


def test_detect_min_on_drops_blips_and_min_gap_merges():
    sr = 1000
    y = np.zeros(10 * sr, np.float32)
    mask = np.zeros(10 * 100 + 1, np.float32)
    mask[100:110] = 1.0
    mask[300:340] = 1.0
    mask[348:400] = 1.0
    kw = dict(chunk_s=5.0, chunk_hop_s=2.5, min_on_s=0.3, min_gap_s=0.15)
    regions = detect_overlap_regions(y, sr, _stub(mask), **kw, device="cpu")
    assert len(regions) == 1
    assert regions.starts[0] == pytest.approx(3.0, abs=0.02)
    assert regions.ends[0] == pytest.approx(4.0, abs=0.02)
    _same(regions, jdetect_overlap_regions(y, sr, _stub(mask), **kw))


def test_detect_no_overlap_empty():
    sr = 1000
    y = np.zeros(5 * sr, np.float32)
    mask = np.zeros(5 * 100 + 1, np.float32)
    assert len(detect_overlap_regions(y, sr, _stub(mask), device="cpu")) == 0


def test_detect_defaults_to_the_card():
    """Without ``device`` the waveform goes to the card; without CUDA that
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    y = np.zeros(6 * 1000, np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        detect_overlap_regions(y, 1000, _stub(np.zeros(601, np.float32)))


def test_detect_hands_the_scorer_batches_of_24_windows_cut_in_place():
    seen = []

    def fn(chunks):
        seen.append((tuple(chunks.shape), chunks.stride()))
        return np.zeros((chunks.shape[0], 501, 3), np.float32)

    y = np.random.default_rng(0).standard_normal(70 * 1000).astype(np.float32)
    detect_overlap_regions(y, 1000, fn, device="cpu")
    # 70 s -> 27 windows -> two batches of 24, views at the 2.5 s stride
    assert seen == [((24, 5000), (2500, 1))] * 2


def test_detect_takes_a_tensor_as_it_takes_an_array():
    """A waveform already on the device is scored in place, with the same
    windows and regions as its host array."""
    sr = 1000
    y = np.random.default_rng(1).standard_normal(12 * sr).astype(np.float32)
    mask = np.zeros(12 * 100 + 1, np.float32)
    mask[420:610] = 1.0
    seen = {}

    def record(key):
        stub = _stub(mask)

        def fn(chunks):
            seen[key] = chunks.clone()
            return stub(chunks)
        return fn

    a = detect_overlap_regions(y, sr, record("array"), device="cpu")
    b = detect_overlap_regions(torch.from_numpy(y), sr, record("tensor"),
                               device="cpu")
    assert len(a) == 1
    _same(a, b)
    torch.testing.assert_close(seen["tensor"], seen["array"], rtol=0, atol=0)


# ---- add_overlap_segments: the cases of
# tests/test_overlap.py::TestAddOverlapSegments -----------------------------
def _two_turns(cls):
    return cls(np.array([0.0, 5.0]), np.array([5.0, 10.0]),
               np.array([0, 1], np.int32))


def _embs(n_win=19, win_s=1.0, hop_s=0.5):
    starts = np.arange(n_win) * hop_s
    e = np.zeros((n_win, 2))
    centers = starts + win_s / 2
    e[centers < 5.0, 0] = 1.0
    e[centers >= 5.0, 1] = 1.0
    return e, starts, win_s


def _both(final_pairs, regions, e, starts, win_s, **kw):
    out = add_overlap_segments(
        SegmentArray(*final_pairs), SegmentArray.from_pairs(regions), e, starts,
        win_s, **kw)
    ref = jadd_overlap_segments(
        JSegmentArray(*final_pairs), JSegmentArray.from_pairs(regions), e,
        starts, win_s, **kw)
    _same(out, ref)
    return out


TWO = (np.array([0.0, 5.0]), np.array([5.0, 10.0]), np.array([0, 1], np.int32))


def test_turn_change_region_adds_both_sides():
    e, starts, win_s = _embs()
    out = _both(TWO, [(4.5, 5.5)], e, starts, win_s)
    assert len(out) == 4
    for spk in (0, 1):
        m = out.spks == spk
        inter = np.clip(np.minimum(out.ends[m], 5.5)
                        - np.maximum(out.starts[m], 4.5), 0, None)
        assert inter.sum() >= 1.0 - 1e-9


def test_backchannel_region_matches_other_centroid():
    e, starts, win_s = _embs()
    centers = starts + win_s / 2
    e[(centers >= 2.0) & (centers < 3.0)] = [0.0, 1.0]
    out = _both(TWO, [(2.0, 3.0)], e, starts, win_s, min_cos=0.10)
    assert len(out) == 3
    new = np.flatnonzero((out.starts == 2.0) & (out.ends == 3.0))
    assert len(new) == 1 and out.spks[new[0]] == 1


def test_backchannel_below_cos_floor_skipped():
    e, starts, win_s = _embs()
    centers = starts + win_s / 2
    e[(centers >= 2.0) & (centers < 3.0)] = [0.0, -1.0]
    assert len(_both(TWO, [(2.0, 3.0)], e, starts, win_s, min_cos=0.10)) == 2


def test_sanity_cap_vetoes_hallucination():
    e, starts, win_s = _embs()
    assert len(_both(TWO, [(0.0, 9.0)], e, starts, win_s,
                     max_overlap_frac=0.5)) == 2


def test_region_outside_speech_skipped():
    e, starts, win_s = _embs()
    assert len(_both(TWO, [(11.0, 12.0)], e, starts, win_s)) == 2


def test_single_speaker_file_unchanged():
    e, starts, win_s = _embs()
    one = (np.array([0.0]), np.array([10.0]), np.array([0], np.int32))
    assert len(_both(one, [(2.0, 3.0)], e, starts, win_s)) == 1


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_add_overlap_segments_equal_on_seeded_inputs(seed):
    rng = np.random.default_rng(seed)
    n_spk, dim, win_s, hop_s = 3, 16, 2.0, 0.1
    edges = np.sort(rng.uniform(0.0, 60.0, 24))
    starts, ends = edges[0::2], edges[1::2]
    spks = rng.integers(0, n_spk, len(starts)).astype(np.int32)
    w_starts = np.arange(0.0, 58.0, hop_s)
    cents = rng.standard_normal((n_spk, dim))
    centers = w_starts + win_s / 2
    lab = np.zeros(len(w_starts), int)
    for s, e_, k in zip(starts, ends, spks):
        lab[(centers >= s) & (centers < e_)] = k
    embs = (cents[lab] + 0.5 * rng.standard_normal((len(w_starts), dim))
            ).astype(np.float32)
    r0 = np.sort(rng.uniform(0.0, 58.0, 6))
    regions = [(float(a), float(a + rng.uniform(0.3, 1.5))) for a in r0]
    out = _both((starts, ends, spks), regions, embs, w_starts, win_s)
    assert len(out) >= len(starts)


# ---- the held-out generator and the shipped detector -----------------------
@pytest.mark.parametrize("kw", [dict(overlap_frac=0.3), dict(),
                                dict(rt60_s=0.3, snr_db=15.0, noise_kind="pink")])
def test_heldout_generator_draws_equal(kw):
    w, t = make_conversation_heldout(np.random.default_rng(9), 8.0, n_speakers=3, **kw)
    jw, jt = jmake_conversation_heldout(np.random.default_rng(9), 8.0,
                                        n_speakers=3, **kw)
    np.testing.assert_array_equal(w, jw)
    for a, b in zip(t, jt):
        np.testing.assert_array_equal(a, b)


def test_standalone_detect_matches_jax_with_the_shipped_detector():
    """12.5 s -> 4 windows, padded to one batch of 24 by both; regions
    within 0.02 s."""
    wave, _ = make_conversation_heldout(np.random.default_rng(4000), 12.5,
                                        n_speakers=3, overlap_frac=0.3)
    model = load_segmentation(WEIGHTS / "segmentation_conv.npz")
    out = detect_overlap_regions(wave, 16000, make_seg_hard_fn(model), device="cpu")
    ref = jdetect_overlap_regions(
        wave, 16000, make_seg_activities_fn(*jload_seg(WEIGHTS / "segmentation_conv.npz")))
    assert len(out) == len(ref) > 0
    np.testing.assert_allclose(out.starts, ref.starts, atol=0.02)
    np.testing.assert_allclose(out.ends, ref.ends, atol=0.02)

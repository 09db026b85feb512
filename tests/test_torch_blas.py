"""The host tail's one BLAS thread (``utils/blas.py``): inside
:func:`single_blas_thread` every loaded BLAS library, numpy's and scipy's,
runs one thread, and the counts from before come back after it, also when
blocks nest or overlap on two threads (the corpus worker's case); the
tail's results are the same to the bit at one thread and at a pool of 8:
``spectral_cluster``, ``refine_labels_by_windows`` (as clustered, and with
a merged pair it splits), a whole ``_segments_from_grid`` of the port, and
that of the frozen reference the benchmark checks the port against.

The inputs are seeded synthetic window embeddings at the calls geometry
(2 s windows at a 0.1 s hop, 128 dimensions) of 35, 117 and 260 s
conversations of 2-3 speakers, and the segments their turns give.
"""
from __future__ import annotations

import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from speech_diarization_tpu_torch import cluster as cm
from speech_diarization_tpu_torch.config import DiarizationConfig
from speech_diarization_tpu_torch.pipelines.diarize import DiarizationPipeline
from speech_diarization_tpu_torch.segment import segment_embeddings_from_grid
from speech_diarization_tpu_torch.types import SegmentArray
from speech_diarization_tpu_torch.utils.blas import blas_threads, single_blas_thread

# an independent reading and setting of every loaded BLAS library
threadpoolctl = pytest.importorskip("threadpoolctl")
threadpool_info, threadpool_limits = threadpoolctl.threadpool_info, threadpoolctl.threadpool_limits

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WIN_S, HOP_S, DIM = 2.0, 0.1, 128
POOL = 8            # the default pool of an 8-core host
CASES = [(35.0, 2, 0), (117.0, 3, 1), (260.0, 3, 2)]


def _blas_counts() -> dict[str, int]:
    return {d["filepath"]: d["num_threads"] for d in threadpool_info()
            if d["user_api"] == "blas"}


def _conversation(seconds: float, n_spk: int, seed: int):
    """-> (turns as a SegmentArray with the true speakers, window
    embeddings [W, 128] float32, window starts [W] in seconds): each window
    the overlap-weighted mix of the speakers inside it, plus noise."""
    rng = np.random.default_rng(seed)
    cents = rng.standard_normal((n_spk, DIM))
    cents /= np.linalg.norm(cents, axis=1, keepdims=True)
    turns, t, prev = [], 0.0, -1
    while True:
        t += rng.uniform(0.3, 0.8)
        end = min(t + rng.uniform(3.0, 8.0), seconds)
        if end - t < 1.0:
            break
        spk = int(rng.integers(0, n_spk))
        spk = (spk + 1) % n_spk if spk == prev else spk
        turns.append((t, end, spk))
        prev, t = spk, end
    starts = np.arange(int(round((seconds - WIN_S) / HOP_S)) + 1) * HOP_S
    mix = np.zeros((len(starts), n_spk))
    for a, b, k in turns:
        mix[:, k] += np.clip(np.minimum(starts + WIN_S, b) - np.maximum(starts, a), 0, None)
    embs = mix @ cents + 0.06 * WIN_S * rng.standard_normal((len(starts), DIM))
    segs = SegmentArray(*(np.asarray(c) for c in zip(*turns)))
    return segs, embs.astype(np.float32), starts


def _merge_first_pair(spks: np.ndarray) -> np.ndarray:
    out = np.where(spks == 1, 0, spks)
    return np.where(out > 1, out - 1, out).astype(np.int32)


def _pipeline(mod_pipe, mod_cfg):
    return mod_pipe(mod_cfg(), encode_fn=lambda x: x, vad_probs_fn=lambda y: y,
                    enhance_fn=lambda y: y, device="cpu")


@pytest.fixture(scope="module")
def pipes():
    from perfbench.reference.config import DiarizationConfig as RefConfig
    from perfbench.reference.pipelines.diarize import DiarizationPipeline as RefPipeline

    return _pipeline(DiarizationPipeline, DiarizationConfig), _pipeline(RefPipeline, RefConfig)


def test_inside_every_blas_library_runs_one_thread():
    with threadpool_limits(limits=3, user_api="blas"):
        before = _blas_counts()
        assert any("numpy" in p for p in before) and any("scipy" in p for p in before)
        assert set(before.values()) == {3}
        with single_blas_thread():
            assert _blas_counts() == dict.fromkeys(before, 1)
            assert blas_threads() == 1
        assert _blas_counts() == before
        assert blas_threads() == 3


def test_nested_blocks_restore_at_the_outermost():
    with threadpool_limits(limits=2, user_api="blas"):
        before = _blas_counts()
        with single_blas_thread():
            with single_blas_thread():
                assert blas_threads() == 1
            assert blas_threads() == 1
        assert _blas_counts() == before


def test_overlapping_threads_restore_when_the_last_leaves():
    """Thread a enters, b enters, a leaves (b still inside: one thread),
    b leaves (the pool is back)."""
    steps = [threading.Event() for _ in range(4)]
    seen = {}

    def a():
        with single_blas_thread():
            steps[0].set()
            steps[1].wait(10)
        steps[2].set()

    def b():
        steps[0].wait(10)
        with single_blas_thread():
            steps[1].set()
            steps[2].wait(10)
            seen["after_a_left"] = blas_threads()
        steps[3].set()

    with threadpool_limits(limits=2, user_api="blas"):
        before = _blas_counts()
        ts = [threading.Thread(target=f) for f in (a, b)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(20)
        assert not any(th.is_alive() for th in ts)
        assert all(e.is_set() for e in steps)
        assert seen["after_a_left"] == 1
        assert _blas_counts() == before


def test_many_threads_never_see_the_pool_while_one_is_inside():
    """More threads than cores enter and leave the block in a tight loop,
    switching often: inside it every thread reads one thread, and the
    counts from before are back once all have left."""
    n_threads, rounds = 2 * (os.cpu_count() or 4), 50
    bad = []

    def work():
        for _ in range(rounds):
            with single_blas_thread():
                if blas_threads() != 1:
                    bad.append(blas_threads())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with threadpool_limits(limits=2, user_api="blas"):
            before = _blas_counts()
            ts = [threading.Thread(target=work) for _ in range(n_threads)]
            for th in ts:
                th.start()
            for th in ts:
                th.join(60)
            assert not any(th.is_alive() for th in ts)
            assert not bad
            assert _blas_counts() == before
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("merged", [False, True], ids=["as_clustered", "merged_pair"])
@pytest.mark.parametrize("seconds,n_spk,seed", CASES)
def test_clustering_equal_at_one_thread(seconds, n_spk, seed, merged):
    segs, embs, starts = _conversation(seconds, n_spk, seed)
    seg_embs = segment_embeddings_from_grid(embs, starts, WIN_S, segs)
    labels = _merge_first_pair(segs.spks) if merged else segs.spks
    assert labels.max() + 1 == n_spk - merged

    def run():
        return (cm.spectral_cluster(seg_embs, max_speakers=8),
                cm.refine_labels_by_windows(labels, segs, embs, starts, WIN_S, 8,
                                            seg_embs=seg_embs))

    with threadpool_limits(limits=POOL, user_api="blas"):
        pooled = run()
        with single_blas_thread():
            one = run()
    for p, o in zip(pooled, one):
        assert p.dtype == o.dtype and np.array_equal(p, o)
    refined = one[1]
    # the merged pair is split again, the true clusters are left alone
    assert refined.max() + 1 == n_spk
    assert np.array_equal(refined, segs.spks) or merged


@pytest.mark.parametrize("seconds,n_spk,seed", CASES)
def test_host_tail_equal_at_one_thread_and_to_the_reference(pipes, seconds, n_spk, seed):
    port, ref = pipes
    segs, embs, starts = _conversation(seconds, n_spk, seed)
    speech = SegmentArray(segs.starts, segs.ends)
    probs = np.zeros(int(seconds * 100), np.float32)

    def tail(pipe):
        with torch.inference_mode():
            return pipe._segments_from_grid(speech, probs, embs, starts, seconds).segments

    with threadpool_limits(limits=POOL, user_api="blas"):
        pooled, ref_out = tail(port), tail(ref)
        with single_blas_thread():
            one = tail(port)
    assert len(one.starts) > 0 and len(set(one.spks.tolist())) == n_spk
    for other in (pooled, ref_out):
        for k in ("starts", "ends", "spks"):
            assert np.array_equal(getattr(one, k), getattr(other, k)), k

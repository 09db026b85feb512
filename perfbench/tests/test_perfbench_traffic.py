"""Each traffic file makes distinct, seed-reproducible files, and every
seed gets the same set of sizes."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import traffic  # noqa: E402

MIXES = sorted(p.stem for p in (ROOT / "perfbench" / "traffic").glob("*.json"))
SEEDS = (7, 2 ** 31 + 11)


def _short(mix: str) -> dict:
    """The mix with its lengths cut to a few seconds, so the test is quick;
    nothing else changes."""
    t = json.loads((ROOT / "perfbench" / "traffic" / f"{mix}.json").read_text())
    t["lengths_s"] = {"fixed": [4.0 + i for i in range(int(t["pool"]))]}
    return t


@pytest.mark.parametrize("mix", MIXES)
def test_plan_is_the_same_for_every_seed(mix):
    t = json.loads((ROOT / "perfbench" / "traffic" / f"{mix}.json").read_text())
    plan = traffic.pool_plan(t)
    assert len(plan) == t["pool"]
    assert all(kw["duration_s"] > 0 for kw in plan)


@pytest.mark.parametrize("mix", MIXES)
def test_pool_reproducible_and_distinct(mix):
    t = _short(mix)
    a = traffic.make_pool(t, SEEDS[1], workers=1)
    b = traffic.make_pool(t, SEEDS[1], workers=1)
    c = traffic.make_pool(t, SEEDS[0], workers=1)
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x.wave, y.wave)
        assert x.wave.shape == z.wave.shape          # the same sizes
        assert not np.array_equal(x.wave, z.wave)    # another draw
    waves = [d.wave for d in a]
    for i in range(len(waves)):
        for j in range(i + 1, len(waves)):
            n = min(len(waves[i]), len(waves[j]))
            assert not np.array_equal(waves[i][:n], waves[j][:n])


@pytest.mark.parametrize("mix", MIXES)
def test_submissions_distinct_and_reproducible(mix):
    t = _short(mix)
    pool = traffic.make_pool(t, SEEDS[0], workers=1)
    s1 = traffic.Submissions(pool, SEEDS[0])
    s2 = traffic.Submissions(pool, SEEDS[0])
    seen = set()
    for _ in range(3 * len(pool)):
        i, off, w = s1.next()
        j, off2, w2 = s2.next()
        assert (i, off) == (j, off2) and np.array_equal(w, w2)
        assert np.array_equal(w, np.roll(pool[i].wave, off))
        seen.add((i, off))
    assert len(seen) == 3 * len(pool)
    # every pass covers the whole pool
    assert sorted(s1.order[:len(pool)]) == list(range(len(pool)))


def test_shift_truth_follows_the_roll():
    truth = (np.array([0.5, 2.0]), np.array([1.5, 3.5]), np.array([0, 1], np.int32))
    n = 4 * traffic.SR
    s, e, k = traffic.shift_truth(truth, traffic.SR, n)      # 1 s to the right
    assert np.allclose(s, [0.0, 1.5, 3.0]) and np.allclose(e, [0.5, 2.5, 4.0])
    assert list(k) == [1, 0, 1]


def _sample(n_check: int, first_pass: int, seed: int, n: int):
    s = traffic.CheckSample(n_check, first_pass, seed)
    held = set()
    for k in range(n):
        kept, gone = s.admit(k)
        assert kept == (k in s.kept)
        assert not set(gone) & s.kept and set(gone) <= held
        held = (held - set(gone)) | ({k} if kept else set())
        assert held == s.kept
    return s.kept


def test_check_sample_from_the_seed():
    a = _sample(4, 8, 5, 400)
    assert a == _sample(4, 8, 5, 400)
    assert 1 <= len(a) <= 4 and max(a) < 400
    assert any(k >= 8 for k in a)                 # one after the first pass


def test_check_sample_spans_the_window():
    """Over many seeds the kept submissions spread over the whole window,
    not its first files; a window within the first pass still keeps one."""
    n = 400
    ks = [k for seed in range(300) for k in _sample(4, 8, seed, n)]
    assert np.mean(ks) > 0.35 * n and np.quantile(ks, 0.9) > 0.75 * n
    assert _sample(4, 8, 3, 5)

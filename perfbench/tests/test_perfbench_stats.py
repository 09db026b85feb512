"""The end-to-end arithmetic on synthetic timings: every completed file,
the whole window, no minimum and no censoring."""
from __future__ import annotations

import statistics
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench.harness import stats  # noqa: E402
from perfbench.series import spread  # noqa: E402


def test_rtf_whole_window():
    # three files of 60, 120 and 30 s done at 0.2, 0.5 and 1.0 s after the
    # window opened at t0 = 10: 210 s over 1.0 s
    assert stats.rtf([60.0, 120.0, 30.0], 10.0, [10.2, 10.5, 11.0]) == pytest.approx(210.0)


def test_rtf_counts_a_stall():
    # a stall before the last file lowers the rate: no file is dropped
    fast = stats.rtf([60.0] * 4, 0.0, [0.1, 0.2, 0.3, 0.4])
    stalled = stats.rtf([60.0] * 4, 0.0, [0.1, 0.2, 0.3, 2.4])
    assert fast == pytest.approx(600.0) and stalled == pytest.approx(100.0)


def test_p95_every_file():
    walls = [0.1] * 190 + [1.0] * 10
    # nearest rank ceil(0.95 * 200) = 190: the slowest ten are beyond it
    assert stats.p95(walls) == 0.1
    assert stats.p95(walls + [2.0]) == 1.0
    assert stats.p95([0.3]) == 0.3
    with pytest.raises(ValueError):
        stats.p95([])


def test_p95_keeps_the_tail():
    walls = [0.1] * 100 + [5.0] * 6
    assert stats.p95(walls) == 5.0


def test_spread_is_the_quartile_distance_over_the_median():
    v = [100.0, 101.0, 102.0, 103.0, 104.0, 105.0]
    q1, _, q3 = statistics.quantiles(v, n=4)
    assert spread(v) == pytest.approx((q3 - q1) / statistics.median(v))


def test_traced_file_p95_reads_the_traced_files():
    from types import SimpleNamespace

    from perfbench.harness import spec

    mod = spec.load_reader("traced_file_p95_s")
    files = [SimpleNamespace(t_submit=float(i), t_done=i + (0.1 if i < 19 else 0.9))
             for i in range(20)]
    # nearest rank ceil(0.95 * 20) = 19: the one slow file lies beyond it
    assert mod.read(SimpleNamespace(files=files)) == pytest.approx(0.1)
    assert mod.read(SimpleNamespace(files=files + files[-1:])) == pytest.approx(0.9)
    assert mod.read(SimpleNamespace(files=[])) is None

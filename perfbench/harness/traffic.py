"""The one traffic generator: a mix's JSON file of parameters -> a pool of
ground-truthed files made from the seed, and the stream of submissions the
closed loop sends.

Every seed gets the same set of sizes: the pool's lengths, speaker counts
and noise levels follow from the mix's parameters alone, and the seed draws
the content of each file, the order of the pool in each pass and, for every
submission, the circular shift that makes it a file the system has not
seen.  So runs with different seeds do the same amount of work.

Parameters of a mix (``traffic/<mix>.json``):

* ``generator``: ``conversation`` (the port's ``train/synthetic.py::
  make_conversation``, copied in ``gen_synthetic.py``) or ``heldout``
  (``train/heldout.py::make_conversation_heldout``, copied in
  ``gen_heldout.py``);
* ``pool``: the number of draws;
* ``lengths_s``: ``{"log_uniform": [lo, hi]}`` (the pool's lengths are the
  midpoints of ``pool`` equal steps of log length) or ``{"fixed": [...]}``;
* ``speakers``: a list cycled over the pool's draws;
* ``noise`` (``heldout``): ``{"kinds": [...], "snr_db": [lo, hi]}``, the
  kinds cycled over the draws and the SNRs evenly spaced over the range;
* ``entry``: ``call`` (one file per ``DiarizationPipeline.__call__``) or
  ``corpus`` (``files_per_call`` files per ``corpus_diarize``);
* ``check_files``: how many completed files the correctness check samples;
* ``source`` and ``reduced``: the public corpus whose documented statistics
  the parameters follow, and what was cut from them (read by no code).
"""
from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
import multiprocessing as mp

import numpy as np

SR = 16000


@dataclass
class Draw:
    wave: np.ndarray                       # float32 [T]
    truth: tuple                           # (starts, ends, spks)
    seconds: float


def pool_plan(traffic: dict) -> list[dict]:
    """The keyword arguments of each draw of the pool (without the rng):
    the same for every seed."""
    n = int(traffic["pool"])
    ls = traffic["lengths_s"]
    if "fixed" in ls:
        lengths = [float(x) for x in ls["fixed"]]
        if len(lengths) != n:
            raise ValueError("lengths_s.fixed must list one length per draw")
    else:
        lo, hi = (float(x) for x in ls["log_uniform"])
        lengths = [lo * (hi / lo) ** ((i + 0.5) / n) for i in range(n)]
    spk = traffic["speakers"]
    plan = []
    for i in range(n):
        kw = {"duration_s": round(lengths[i], 3), "n_speakers": int(spk[i % len(spk)])}
        if traffic["generator"] == "heldout" and traffic.get("noise"):
            nz = traffic["noise"]
            lo, hi = (float(x) for x in nz["snr_db"])
            kw["noise_kind"] = nz["kinds"][i % len(nz["kinds"])]
            kw["snr_db"] = lo + (hi - lo) * (i / (n - 1) if n > 1 else 0.5)
        plan.append(kw)
    return plan


def _make_one(generator: str, seed: int, index: int, kw: dict):
    rng = np.random.default_rng([int(seed), int(index)])
    if generator == "conversation":
        from perfbench.harness.gen_synthetic import make_conversation

        return make_conversation(rng, kw["duration_s"], n_speakers=kw["n_speakers"], sr=SR)
    if generator == "heldout":
        from perfbench.harness.gen_heldout import make_conversation_heldout

        return make_conversation_heldout(rng, sr=SR, **kw)
    raise ValueError(f"unknown generator {generator!r}")


class PendingPool:
    """A pool of a mix for ``seed`` being made in up to ``workers`` spawned
    processes (numpy only), so that set-up can build the system meanwhile;
    :meth:`collect` waits for the draws and ends the processes."""

    def __init__(self, traffic: dict, seed: int, workers: int = 4):
        plan = pool_plan(traffic)
        gen = traffic["generator"]
        self._ex = None
        if workers <= 1 or len(plan) == 1:
            self._outs = [_make_one(gen, seed, i, kw) for i, kw in enumerate(plan)]
        else:
            self._ex = ProcessPoolExecutor(min(workers, len(plan)),
                                           mp_context=mp.get_context("spawn"))
            self._futs = [self._ex.submit(_make_one, gen, seed, i, kw)
                          for i, kw in enumerate(plan)]

    def collect(self) -> list[Draw]:
        if self._ex is not None:
            try:
                self._outs = [f.result() for f in self._futs]
            finally:
                self._ex.shutdown(wait=True, cancel_futures=True)
                self._ex = None
        return [Draw(np.ascontiguousarray(w, np.float32), truth, w.shape[-1] / SR)
                for w, truth in self._outs]


def make_pool(traffic: dict, seed: int, workers: int = 4) -> list[Draw]:
    """The pool of a mix for ``seed``, made and collected."""
    return PendingPool(traffic, seed, workers).collect()


def shift_truth(truth: tuple, offset: int, n: int) -> tuple:
    """The truth of ``np.roll(wave, offset)``: every turn moves by the
    offset, and a turn that wraps past the end is split in two."""
    starts, ends, spks = (np.asarray(a) for a in truth)
    dur = n / SR
    d = offset / SR
    out_s, out_e, out_k = [], [], []
    for s, e, k in zip(starts, ends, spks):
        s2, e2 = s + d, e + d
        for a, b in ((s2, e2), (s2 - dur, e2 - dur)):
            lo, hi = max(a, 0.0), min(b, dur)
            if hi > lo:
                out_s.append(lo)
                out_e.append(hi)
                out_k.append(k)
    order = np.argsort(out_s, kind="stable")
    return (np.asarray(out_s, np.float64)[order], np.asarray(out_e, np.float64)[order],
            np.asarray(out_k, np.int32)[order])


class Submissions:
    """The closed loop's files: submission ``k`` is a draw of the pool (each
    pass over the pool in a seeded order), circularly shifted by a seeded
    offset, with its truth shifted to match."""

    def __init__(self, pool: list[Draw], seed: int):
        self.pool = pool
        self.rng = np.random.default_rng([int(seed), 7919])
        self.order: list[int] = []
        self.k = 0

    def draw_index(self) -> int:
        while len(self.order) <= self.k:
            self.order.extend(int(i) for i in self.rng.permutation(len(self.pool)))
        return self.order[self.k]

    def next(self) -> tuple[int, int, np.ndarray]:
        """-> (draw index, offset, shifted wave)."""
        i = self.draw_index()
        w = self.pool[i].wave
        off = int(self.rng.integers(1, w.shape[-1]))
        self.k += 1
        return i, off, np.roll(w, off)


class CheckSample:
    """The submissions whose outputs the check compares, drawn from the seed
    over the whole window as it runs: ``n_check - 1`` (at least one) by
    reservoir sampling over every submission, and one over the submissions
    after the pool's first pass (repeated draws, with state left by earlier files).  Each
    submission is admitted or not before it runs, so its outputs can be
    caught while it runs; :meth:`admit` returns the submissions it pushes
    out, whose outputs may be dropped.  A window that ends within the first
    pass is checked on what it admitted."""

    def __init__(self, n_check: int, first_pass: int, seed: int):
        self.n_all = max(1, int(n_check) - 1)
        self.first_pass = int(first_pass)
        self.rng = np.random.default_rng([int(seed), 104729])
        self.all: list[int] = []
        self.later: list[int] = []
        self._seen_later = 0

    def _offer(self, slots: list[int], size: int, seen: int, k: int) -> int | None:
        """Reservoir sampling (Algorithm R): -> the submission pushed out,
        ``k`` itself when it is not admitted, None when a slot was free."""
        if len(slots) < size:
            slots.append(k)
            return None
        j = int(self.rng.integers(0, seen + 1))
        if j < size:
            out, slots[j] = slots[j], k
            return out
        return k

    def admit(self, k: int) -> tuple[bool, list[int]]:
        """Offer submission ``k`` (in order): -> (it is kept, the submissions
        no longer kept)."""
        out = [self._offer(self.all, self.n_all, k, k)]
        if k >= self.first_pass:
            out.append(self._offer(self.later, 1, self._seen_later, k))
            self._seen_later += 1
        kept = self.kept
        return k in kept, sorted({o for o in out if o is not None and o != k and o not in kept})

    @property
    def kept(self) -> set[int]:
        return set(self.all) | set(self.later)

"""One BLAS thread for the host tail's dense algebra.

The host tail (VAD post-processing, clustering and its window refine, the
merges, frame reassignment) makes small LAPACK and BLAS calls: a thin SVD
of each cluster's window embeddings (``[M, 128]``, M in the hundreds to
thousands), ``eigh`` of a padded Laplacian, a few products.  numpy's and
scipy's OpenBLAS each start one thread per core; on problems this small
waking the pool costs more than its threads save, the more so beside
torch's own threads and the CUDA launch thread.  :func:`single_blas_thread`
holds every loaded OpenBLAS at one thread for a block and restores the
counts it found.  The calls and their inputs stay the same, and their
results do not change by a bit (``tests/test_torch_blas.py``).

The limit is process-wide (OpenBLAS keeps one setting a library), so
blocks that overlap share it: a count under a lock, the first block to
enter sets the limit and the last to leave restores it.  That is the
corpus worker's case, one thread a device, each running its files' tails.
The libraries are found once a process, after ``scipy.linalg`` has loaded
scipy's OpenBLAS: every mapped ``libopenblas*``, ``libblas*`` or
``libscipy_openblas*`` that exports OpenBLAS's thread-count entry points
(numpy's wheels carry a 64-bit-integer build whose entry points are
``scipy_openblas_*64_``, scipy's a 32-bit one), reached through ``ctypes``.
Another BLAS (MKL, BLIS) is left as it is.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import threading

_NAMES = ("libopenblas", "libblas", "libscipy_openblas")
_AFFIXES = [(p, s) for p in ("", "scipy_") for s in ("", "64_", "_64")]

_LOCK = threading.Lock()
_DEPTH = 0               # blocks open across the process's threads
_SAVED: list[int] = []   # each library's thread count before the first block
_POOLS = None            # [(get, set)] of every loaded OpenBLAS


def _mapped_libraries() -> list[str]:
    """The paths of the OpenBLAS libraries mapped into this process."""
    try:
        with open("/proc/self/maps") as f:
            rows = [ln.split(maxsplit=5) for ln in f]
    except OSError:       # no procfs: nothing to limit
        return []
    paths = [r[5].strip() for r in rows if len(r) == 6]
    return list(dict.fromkeys(p for p in paths
                              if os.path.basename(p).startswith(_NAMES)))


def _pools():
    """``[(get_num_threads, set_num_threads)]`` of every loaded OpenBLAS
    (found at first use)."""
    global _POOLS
    if _POOLS is None:
        import scipy.linalg  # noqa: F401 - loads scipy's OpenBLAS first

        pools = []
        for path in _mapped_libraries():
            lib = ctypes.CDLL(path)
            for pre, suf in _AFFIXES:
                get = getattr(lib, f"{pre}openblas_get_num_threads{suf}", None)
                put = getattr(lib, f"{pre}openblas_set_num_threads{suf}", None)
                if get is not None and put is not None:
                    get.argtypes, get.restype = [], ctypes.c_int
                    put.argtypes, put.restype = [ctypes.c_int], None
                    pools.append((get, put))
                    break
        _POOLS = pools
    return _POOLS


@contextlib.contextmanager
def single_blas_thread():
    """Every loaded OpenBLAS runs on one thread inside the block; the
    thread counts from before the first open block come back when the last
    one closes, whichever thread opened it."""
    global _DEPTH, _SAVED
    with _LOCK:
        if _DEPTH == 0:
            _SAVED = [get() for get, _ in _pools()]
            for _, put in _pools():
                put(1)
        _DEPTH += 1
    try:
        yield
    finally:
        with _LOCK:
            _DEPTH -= 1
            if _DEPTH == 0:
                for (_, put), n in zip(_pools(), _SAVED):
                    put(n)


def blas_threads() -> int:
    """The largest thread count among the loaded OpenBLAS libraries (0
    when none is loaded)."""
    return max((get() for get, _ in _pools()), default=0)

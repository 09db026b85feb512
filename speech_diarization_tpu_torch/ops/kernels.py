"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``build/`` beside this package (the
directory is git-ignored).  The library file name carries a hash of its
source, so an edited kernel is rebuilt and a stale one is never loaded.
Libraries are loaded with ``ctypes``: every pointer and the CUDA stream are
passed as ``c_void_p`` (a bare Python int would be cut to 32 bits), and each
C entry returns ``cudaGetLastError()`` after its launch, which the wrapper
turns into an exception.

Nothing here is imported, compiled or loaded when the package is imported:
the CPU tests import every module on a machine without ``nvcc``.

``LAUNCHES`` counts kernel launches, one per wrapper call that reaches a
kernel; a run resets it with :func:`reset_launches` and reads it afterwards
to show that its main path went through the kernels.  ``LAUNCH_FORMS``
counts the same launches by the form of the call where a wrapper names one
(the log-mel's ``[T]`` and ``[B, T]`` entries), and ``LAUNCH_SHAPES`` by
the geometry the wrapper names at the point of launch (the log-mel's row
length, row stride and mel count, K1's padded attention width and
channels, K3's ``up`` and ``down``), which tells apart the callers that
share one form.  The counters are bumped
under a lock: the shards of a mesh step launch from threads.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parents[1]
CSRC = PKG_ROOT / "csrc"
BUILD = PKG_ROOT / "build"

_P, _I, _F, _L = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_longlong)

# kernel name -> (source file, C entry point, ctypes argument types)
KERNELS = {
    "asp_grid_stats": ("asp_grid.cu", "sdt_asp_grid_stats",
                       # x, t_f, first_f, cc, bw, w1x, s_bn, t_bn, w2, a_dim,
                       # hop_f, win_f, n_windows, n_rows, x_t, hx, out, stream
                       [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _P, _P, _P, _P]),
    "fused_log_mel": ("fused_fbank.cu", "sdt_fused_log_mel",
                      # y, n_batch, y_stride, t, basis, n_ksteps, mel_idx,
                      # mel_w, nnz, n_fft, hop, n_mels, eps, out, n_frames,
                      # stream
                      [_P, _I, _L, _I, _P, _I, _P, _P, _I, _I, _I, _I, _F, _P,
                       _I, _P]),
    "resample_poly": ("resample_poly.cu", "sdt_resample_poly",
                      # x, n_ch, t, bank, up, down, n_taps, half, out, n_out,
                      # stream
                      [_P, _I, _L, _P, _I, _I, _I, _I, _P, _L, _P]),
}

LAUNCHES: dict[str, int] = {name: 0 for name in KERNELS}
# open tallies (:func:`tally`): each collects (name, work) of every launch
_TALLIES: list[list] = []
LAUNCH_FORMS: dict[str, int] = {}
LAUNCH_SHAPES: dict[str, int] = {}
_COUNT_LOCK = threading.Lock()

_LIBS: dict[str, ctypes.CDLL] = {}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        LAUNCH_FORMS.clear()
        LAUNCH_SHAPES.clear()


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (set NVCC to its path)")


def _lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}_{digest}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns each kernel's
    compiler report (``-Xptxas -v``: registers, shared memory, spills);
    raises with the compiler's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        reports[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, KERNELS[name][1])
        fn.argtypes = KERNELS[name][2]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


@contextlib.contextmanager
def tally():
    """Collect ``(name, work)`` for every launch inside the block, ``work``
    being the analytic count of ``ops/cost.py`` the wrapper names
    (``utils/profiling.py::model_complexity`` adds them to what PyTorch's
    counters see)."""
    rec: list = []
    _TALLIES.append(rec)
    try:
        yield rec
    finally:
        _TALLIES.remove(rec)


def launch(name: str, *args, device=None, form: str | None = None,
           shape: str | None = None, work=None) -> None:
    """Call a kernel's C entry point and count the launch (also under
    ``form`` and ``shape`` when given); raises if the launch was refused
    (``cudaGetLastError()`` nonzero).  ``device``: the CUDA device of the
    launch's tensors, made the current device around the call (the C entry
    launches on the calling thread's current device, whatever stream it is
    handed).  ``work``: a callable returning the launch's analytic count,
    called only while a :func:`tally` is open."""
    fn = getattr(library(name), KERNELS[name][1])
    if device is None:
        rc = fn(*args)
    else:
        import torch

        with torch.cuda.device(device):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if form is not None:
            key = f"{name}{form}"
            LAUNCH_FORMS[key] = LAUNCH_FORMS.get(key, 0) + 1
        if shape is not None:
            key = f"{name} {shape}"
            LAUNCH_SHAPES[key] = LAUNCH_SHAPES.get(key, 0) + 1
        tallies = list(_TALLIES)
    if work is not None and tallies:
        w = work()
        for rec in tallies:
            rec.append((name, w))


def check_cuda_tensor(t, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` when given)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def refuse_autograd(name: str, *tensors) -> None:
    """Raise when autograd is recording and an input requires grad: the
    kernels have no backward, and their outputs would carry no ``grad_fn``,
    so a loss through them would train nothing upstream without a word.
    Training takes the plain differentiable path instead (the ASP's
    ``backend='decomposed'``; the log-mel of data, which needs no grad)."""
    import torch

    if torch.is_grad_enabled() and any(
            getattr(t, "requires_grad", False) for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            "grad; take the plain differentiable path (for the pooling: "
            "backend='decomposed'), or call it under torch.no_grad()")

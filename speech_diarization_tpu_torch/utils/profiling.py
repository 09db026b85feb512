"""Profiling helpers: named wall-clock spans, a device trace, operation and
byte counts of a callable, parameter counts, and the card's clock.

:class:`Profiler` accumulates spans as the JAX package's does; its
:meth:`Profiler.trace` writes a Chrome trace through ``torch.profiler``
where the JAX one captures an XLA trace.  :func:`model_complexity` returns
the JAX function's keys, counted by PyTorch's dispatcher instead of XLA's
cost analysis (see its docstring for how the two differ).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class Profiler:
    """Accumulates named wall-clock spans; :meth:`trace` captures a device
    trace."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    @contextlib.contextmanager
    def trace(self, logdir: str | Path):
        """Profile the block with ``torch.profiler`` (the CPU, and the card
        when there is one) and write ``logdir/trace.json`` (Chrome trace
        format).  Yields the profiler, whose ``key_averages()`` sums the
        events by name."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        out = Path(logdir)
        out.mkdir(parents=True, exist_ok=True)
        with profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(str(out / "trace.json"))

    def report(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k],
                "mean_s": self.totals[k] / max(self.counts[k], 1)}
            for k in sorted(self.totals)
        }


class _BytesMode(TorchDispatchMode):
    """Sums the bytes of every aten operation's tensor inputs and outputs,
    as if each operand went to and from memory (no fusion).  View
    operations move nothing and are not counted; an in-place output counts
    once beside its input."""

    def __init__(self) -> None:
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            ins = [t for t in tree_flatten((args, kwargs or {}))[0]
                   if isinstance(t, torch.Tensor)]
            seen = {id(t) for t in ins}
            outs = [t for t in tree_flatten(out)[0]
                    if isinstance(t, torch.Tensor) and id(t) not in seen]
            self.total += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


def model_complexity(fn: Callable, *example_args: Any) -> dict[str, float]:
    """Operations and bytes of one call of ``fn`` on ``example_args``.

    ``flops``: the matrix products and convolutions that
    ``torch.utils.flop_counter.FlopCounterMode`` counts (two per
    multiply-add), plus, for each kernel launch of the call, the analytic
    count of ``ops/cost.py`` (the kernels are launched through ctypes, out
    of the counter's sight; on the CPU their plain versions run and are
    counted as products).  Elementwise work is not counted, where XLA's
    cost analysis counts it: the figures agree only on a call that is all
    products.  ``bytes_accessed``: every aten operation's operands read
    and its results written, with no fusion (an upper figure beside XLA's,
    which counts fused programs), plus the kernels' analytic bytes."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..ops import kernels

    counter = FlopCounterMode(display=False)
    nbytes = _BytesMode()
    with kernels.tally() as launched, counter, nbytes:
        fn(*example_args)
    return {
        "flops": float(counter.get_total_flops()
                       + sum(w["flops"] for _, w in launched)),
        "bytes_accessed": float(nbytes.total
                                + sum(w["bytes"] for _, w in launched)),
    }


def count_params(params) -> int:
    """Number of values in a net or a parameter tree as the JAX package
    counts its tree: for an ``nn.Module``, its parameters and its floating
    persistent buffers (BatchNorm's running statistics, which the JAX tree
    and the npz hold as leaves); for a mapping or sequence, every array or
    tensor in it."""
    if isinstance(params, torch.nn.Module):
        return int(sum(v.numel() for v in params.state_dict().values()
                       if v.is_floating_point()))
    if isinstance(params, Mapping):
        return int(sum(count_params(v) for v in params.values()))
    if isinstance(params, (list, tuple)):
        return int(sum(count_params(v) for v in params))
    return int(np.prod(np.shape(params)))


def cuda_time_ms(fn, iters: int = 20) -> float:
    """Mean time (ms) of ``fn`` on the card: CUDA events around ``iters``
    calls after a warm one.  Two large matrix products go first and keep
    the card busy for a few milliseconds while the host queues the timed
    calls behind them: a kernel of some 30 us is otherwise timed at the
    host's launch rate."""
    hold = _hold()
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    hold @ hold
    hold @ hold
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


_HOLD: list = []


def _hold() -> torch.Tensor:
    if not _HOLD:
        _HOLD.append(torch.ones((4096, 4096), device="cuda"))
    return _HOLD[0]

"""The traced run's readings, from the benchmark's own files.

* Host stage records: the port's ``stage_timer`` logs ``stage=<name>
  wall_s=<s>`` at INFO under the ``sdtpu`` logger; a handler here sums the
  unrounded seconds by stage.  Only the host stages are read: ``enhance``,
  ``demix`` and ``dispatch`` time the host's enqueue, not the device.
* Device activity: ``torch.profiler`` with CUDA activity only, over the
  measured window; kernels, copies and fills count as busy.
* Launch geometry: ``ops/kernels.py::launch`` of the port wrapped to keep
  each launch's arguments, from which the copied ``ops/cost.py`` works out
  the launch's operations and bytes.
* Spans that metric readers install (CUDA events or host walls around a
  method of the pipeline instance), kept in ``ctx.spans``.

Every wrapper is put on in :meth:`TraceContext.wrap` and taken off in
:meth:`TraceContext.restore`.
"""
from __future__ import annotations

import logging
import time
from collections import defaultdict


class _StageHandler(logging.Handler):
    def __init__(self, ctx):
        super().__init__(logging.INFO)
        self.ctx = ctx

    def emit(self, record):
        if (record.msg == "stage=%s wall_s=%.3f" and isinstance(record.args, tuple)
                and len(record.args) == 2):
            stage, wall = record.args
            self.ctx.stage_s[stage] += float(wall)
            end = record.created - self.ctx.wall_minus_perf
            self.ctx.host_spans.append((stage, end - float(wall), end))


class TraceContext:
    """What a traced window leaves for the metric readers."""

    def __init__(self, system, pipe, config: dict):
        self.system = system
        self.pipe = pipe
        self.config = config
        self.stage_s: dict[str, float] = defaultdict(float)
        self.spans: dict[str, list] = defaultdict(list)
        self.host_spans: list[tuple[str, float, float]] = []
        self.launches: list[tuple[str, tuple]] = []
        self.kernels: dict[str, list[float]] = {}      # name -> [device s, calls]
        self.device_intervals: list[tuple[float, float]] = []
        self.busy_s = 0.0
        self.window_s = 0.0
        self.audio_s = 0.0
        self.files: list = []                 # completed FileRun entries
        self.flops_of_file = None             # callable(draw index) -> flops
        self.wall_minus_perf = time.time() - time.perf_counter()
        self._undo: list = []
        self._handler = None
        self._levels = None
        self._prof = None
        self.t0 = 0.0
        self.active = False

    # -- wrappers -----------------------------------------------------------
    def wrap(self, obj, attr: str, make):
        """Replace ``obj.attr`` by ``make(original)`` until :meth:`restore`."""
        orig = getattr(obj, attr)
        had = attr in getattr(obj, "__dict__", {})
        setattr(obj, attr, make(orig))
        self._undo.append((obj, attr, orig, had))

    def restore(self) -> None:
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo.clear()

    def cuda_span(self, name: str):
        """A wrapper factory: CUDA events around each call, kept under
        ``name`` as (start, end) pairs until :meth:`span_ms` reads them."""
        import torch

        spans = self.spans[name]

        def make(orig):
            def call(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = orig(*a, **k)
                e1.record()
                spans.append((e0, e1))
                return out
            return call
        return make

    def host_span(self, name: str):
        """A wrapper factory: the host wall of each call, in seconds."""
        spans = self.spans[name]
        host = self.host_spans

        def make(orig):
            def call(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                t1 = time.perf_counter()
                spans.append(t1 - t0)
                host.append((name, t0, t1))
                return out
            return call
        return make

    def span_ms(self, name: str) -> float | None:
        v = self.spans.get(name)
        if not v:
            return None
        if isinstance(v[0], tuple):
            return float(sum(a.elapsed_time(b) for a, b in v))
        return 1e3 * float(sum(v))

    # -- the window -----------------------------------------------------------
    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        from speech_diarization_tpu_torch.ops import kernels

        launches = self.launches

        def make(orig):
            def launch(name, *args, **kw):
                launches.append((name, args))
                return orig(name, *args, **kw)
            return launch

        self.wrap(kernels, "launch", make)
        root = logging.getLogger("sdtpu")
        self._handler = _StageHandler(self)
        self._levels = (root.level, [(h, h.level) for h in root.handlers])
        for h in root.handlers:
            h.setLevel(logging.WARNING)
        root.addHandler(self._handler)
        root.setLevel(logging.INFO)
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.active = True
        # a marker on the device: the trace's first event, at the host's t0
        torch.zeros(1, device="cuda").add_(1.0)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.active = False
        self._prof.__exit__(None, None, None)
        root = logging.getLogger("sdtpu")
        root.removeHandler(self._handler)
        level, hl = self._levels
        root.setLevel(level)
        for h, lv in hl:
            h.setLevel(lv)
        self.restore()
        self._read_profile()

    def _read_profile(self) -> None:
        events = []
        try:
            raw = self._prof.profiler.kineto_results.events()
            for e in raw:
                if str(e.device_type()).endswith("CUDA"):
                    if hasattr(e, "start_ns"):
                        t, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
                    else:
                        t, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
                    events.append((e.name(), t, d))
        except AttributeError:
            from torch.autograd import DeviceType

            for e in self._prof.events():
                if e.device_type == DeviceType.CUDA:
                    events.append((e.name, e.time_range.start * 1e-6,
                                   (e.time_range.end - e.time_range.start) * 1e-6))
        if not events:
            return
        kern: dict[str, list[float]] = {}
        for name, _, dur in events:
            k = kern.setdefault(name, [0.0, 0])
            k[0] += dur
            k[1] += 1
        self.kernels = kern
        events.sort(key=lambda e: e[1])
        base = events[0][1]
        merged: list[list[float]] = []
        for _, s, d in events:
            s -= base
            e = s + d
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.device_intervals = [(a, b) for a, b in merged]
        self.busy_s = float(sum(b - a for a, b in merged))

    # -- breakdown ---------------------------------------------------------------
    def breakdown(self) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        gaps: dict[str, float] = defaultdict(float)
        spans = sorted(self.host_spans, key=lambda s: s[2] - s[1])
        iv = self.device_intervals
        edges = [(0.0, 0.0)] + iv + [(self.window_s, self.window_s)]
        for (_, a_end), (b_start, _) in zip(edges, edges[1:]):
            g = b_start - a_end
            if g <= 0:
                continue
            mid = self.t0 + a_end + g / 2
            label = next((n for n, s, e in spans if s <= mid <= e), "between files")
            gaps[label] += g
        top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, float(v[0])] for n, v in ops],
                "idle_gaps": [[n, float(v)] for n, v in top]}

    def audio_min(self) -> float:
        return self.audio_s / 60.0

"""One run of one cell: set-up, the measured window, the check, the result.

The window is closed loop with one client: a file is submitted when the
previous one has completed (``entry: call``), or a corpus call of
``files_per_call`` files when the previous call has returned (``entry:
corpus``).  Whole files run until ``--seconds`` has passed; none is cut.
``rtf`` is the audio of every file completed in the window over the wall
from the window's start to the last completion; ``file_p95_s`` the 95th
percentile of every completed file's wall from its submission to its
result.
"""
from __future__ import annotations

import gc
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np

from . import check, stats, traffic
from .spec import BENCH, Cell
from .systems import build, stated_precision

FORBIDDEN = ("jax", "jaxlib", "flax", "speech_diarization_tpu")
# the traced share of a --trace 1 window, seconds: the trace's size, and the
# time to read it, grow with the files it holds
TRACE_S = 20.0


@dataclass
class FileRun:
    k: int                      # submission index
    draw: int                   # pool index
    offset: int                 # circular shift, samples
    t_submit: float
    t_done: float
    seconds: float              # audio length
    result: object = None
    error: str | None = None


@dataclass
class Window:
    files: list[FileRun] = field(default_factory=list)
    t0: float = 0.0
    attempted: int = 0


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), or since the
    harness was imported where ``/proc`` is absent."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def load_limits(cell: str) -> dict:
    path = BENCH / "limits" / f"{cell}.json"
    with open(path) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def run_window(system, pipe, subs: traffic.Submissions, t: dict, seconds: float,
               cap: check.Capture, sample: traffic.CheckSample, alter=None,
               on_done=None) -> Window:
    """The closed loop over ``seconds``: whole files, none cut.  Each
    submission is offered to the check's ``sample`` before it runs, so
    ``cap`` catches the outputs of the files kept.  ``on_done(now, files)``
    is called after each completion."""
    entry = t.get("entry", "call")
    per_call = int(t.get("files_per_call", 1))
    win = Window()
    win.t0 = prev = time.perf_counter()
    deadline = win.t0 + seconds
    k = 0
    while time.perf_counter() < deadline:
        if entry == "call":
            i, off, wave = subs.next()
            cap.by_src[id(wave)] = k
            cap.admit(k, sample)
            res = err = None
            try:
                res = pipe(wave)
                if alter is not None:
                    res = alter(k, res)
            except Exception as e:  # noqa: BLE001 - counted as failed
                err = f"{type(e).__name__}: {e}"
            now = time.perf_counter()
            win.files.append(FileRun(k, i, off, prev, now, wave.shape[-1] / traffic.SR,
                                     res, err))
            prev = now
            k += 1
            if on_done is not None:
                on_done(now, win.files)
        else:
            batch = [subs.next() for _ in range(per_call)]
            for j, (_, _, w) in enumerate(batch):
                cap.by_src[id(w)] = k + j
                cap.admit(k + j, sample)
            try:
                results, errors = system.corpus([w for _, _, w in batch], pipe)
                failed = {e.get("index") for e in errors}
            except Exception as e:  # noqa: BLE001 - the whole call failed
                results, failed = {}, set(range(per_call))
                err_all = f"{type(e).__name__}: {e}"
            else:
                err_all = None
            now = time.perf_counter()
            for j, (i, off, w) in enumerate(batch):
                res = results.get(j)
                if res is not None and alter is not None:
                    res = alter(k + j, res)
                err = err_all or ("failed in the corpus" if j in failed or res is None
                                  else None)
                win.files.append(FileRun(k + j, i, off, prev, now,
                                         w.shape[-1] / traffic.SR, res, err))
            prev = now
            k += per_call
            if on_done is not None:
                on_done(now, win.files)
    win.attempted = k
    return win


def warm_up(system, pipe, pool, t: dict) -> None:
    """Every shape the cell's traffic uses: each draw of the pool once, in
    the cell's entry."""
    import torch

    if t.get("entry", "call") == "call":
        for d in pool:
            pipe(d.wave)
    else:
        per = int(t.get("files_per_call", 1))
        waves = [pool[i % len(pool)].wave for i in range(per)]
        system.corpus(waves, pipe)
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reference_numbers(system, pool, runs: list[FileRun], prog_outs: dict,
                      keep: set) -> dict[str, float]:
    """The check's numbers over the sampled files (see ``check.py``)."""
    ref = system.reference()
    cap = check.Capture(ref, keep)
    per_file = []
    try:
        for r in runs:
            wave = np.roll(pool[r.draw].wave, r.offset)
            cap.by_src[id(wave)] = r.k
            rres = ref(wave)
            rout = check.FileOut.of(rres, cap, r.k)
            nums = check.compare(prog_outs[r.k], rout)
            step = check.encoder_step_gap(ref, prog_outs[r.k])
            if step is not None:
                nums["enc_step_gap"] = step
            stitch = check.stitch_mismatch(prog_outs[r.k])
            if stitch is not None:
                nums["stitch_mismatch"] = stitch
            tail = check.tail_mismatch(ref, prog_outs[r.k], wave.shape[-1])
            nums["tail_mismatch"] = float(tail + (prog_outs[r.k].route != rout.route))
            per_file.append(nums)
            for store in (cap.enhanced, cap.det_logits, cap.enc_io):
                store.clear()
    finally:
        cap.release()
    return check.worst(per_file)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool = False,
             device=None, control: bool = False, fault=None,
             limits: dict | None = None, pool_workers: int = 4) -> dict:
    """One run.  ``control``: the reference one precision step below the
    configuration's in the program's place.  ``fault(system)``: breaks the
    timed path underneath (the check's own tests); it may return a function
    ``(k, result) -> result`` that alters each answer.  Returns the result's
    fields and the numbers the check compared."""
    import torch

    t = cell.traffic
    # set-up's phases, seconds since the process started, for reading only
    phases = {"imported": process_age_s()}
    # the pool's draws are made in other processes while the system builds
    pending = traffic.PendingPool(t, seed, workers=pool_workers)
    try:
        system = build(cell.config, seed, device)
        phases["built"] = process_age_s()
    finally:
        pool = pending.collect()
    phases["pool"] = process_age_s()
    pipe = system.program
    lower = None
    if control:
        from .precision import lower_precision

        pipe = system.reference(stated=True)
        lower = lower_precision(stated_precision(cell.config))
        lower.__enter__()
    alter = fault(system) if fault is not None else None
    try:
        warm_up(system, pipe, pool, t)
        phases["warm"] = process_age_s()
        sample = traffic.CheckSample(int(t.get("check_files", 4)), len(pool), seed)
        cap = check.Capture(pipe, ())
        ctx = None
        readers = []
        if trace:
            from .spec import load_reader
            from .trace import TraceContext

            ctx = TraceContext(system, pipe, cell.config)
            readers = [(m["name"], load_reader(m["name"])) for m in cell.per_layer]
            for _, mod in readers:
                if hasattr(mod, "install"):
                    mod.install(ctx)
            ctx.start()
        setup_s = process_age_s()
        subs = traffic.Submissions(pool, seed)
        on_done = None
        if ctx is not None:
            def on_done(now, files):
                # the trace covers the window's first TRACE_S seconds (the
                # files completed in them); the load runs on to the end
                if ctx.active and now - ctx.t0 >= TRACE_S:
                    ctx.stop()
                    ctx.files = [f for f in files if f.error is None and f.result is not None]
        try:
            win = run_window(system, pipe, subs, t, seconds, cap, sample, alter, on_done)
        finally:
            if ctx is not None and ctx.active:
                ctx.stop()
                ctx.files = [f for f in win.files if f.error is None and f.result is not None]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        cap.release()
    finally:
        if lower is not None:
            lower.__exit__(None, None, None)
    done = [f for f in win.files if f.error is None and f.result is not None]
    out = {"attempted": win.attempted, "failed": win.attempted - len(done),
           "errors": [f.error for f in win.files if f.error][:3],
           "setup_phases": {**phases, "window": setup_s}}
    if device is None:
        out["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    metrics = {}
    if not trace:
        if done:
            metrics["rtf"] = stats.rtf([f.seconds for f in done],
                                       win.t0, [f.t_done for f in done])
            metrics["file_p95_s"] = stats.p95([f.t_done - f.t_submit for f in done])
        metrics["setup_s"] = setup_s
    else:
        ctx.audio_s = sum(f.seconds for f in ctx.files)
        ctx.flops_of_file = lambda f: system_flops(system, pool, f)
        for name, mod in readers:
            v = mod.read(ctx)
            if v is not None:
                metrics[name] = float(v)
        out["busy_s"] = ctx.busy_s
        out["window_s"] = ctx.window_s
        out["breakdown"] = ctx.breakdown()
    out["metrics"] = metrics
    out["n_done"] = len(done)
    out["der_mean"] = stats.mean_der(pool, done, traffic.shift_truth)

    # the check: the program's outputs on the seeded sample, once its state
    # is freed
    keep = sample.kept
    runs = [f for f in done if f.k in keep]
    prog_outs = {f.k: check.FileOut.of(f.result, cap, f.k) for f in runs}
    missing = sorted(keep - {f.k for f in runs})
    for f in win.files:
        if f.k not in keep:
            f.result = None
    for store in (cap.enhanced, cap.det_logits, cap.enc_io):
        store.clear()
    system.program = None
    del pipe
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    numbers = reference_numbers(system, pool, runs, prog_outs, keep) if runs else {}
    if missing:
        numbers["tail_mismatch"] = numbers.get("tail_mismatch", 0.0) + len(missing)
    lim = load_limits(cell.name) if limits is None else limits
    ok, table = check.judge(numbers, lim)
    out["numbers"] = numbers
    out["check"] = table
    out["correct"] = bool(ok and out["failed"] == 0 and win.attempted > 0)
    return out


def system_flops(system, pool, f: FileRun) -> float:
    from .flops import file_flops

    return file_flops(system, pool[f.draw].wave.shape[-1], f.result)

"""Corpus-scale diarization: one worker per card pulling files from a shared
queue, with the next file's work started before the current one finishes.

The JAX package's ``pipelines/corpus.py`` (``CorpusReport``,
``corpus_diarize``).  Per worker, while file ``i`` finishes (its one packed
device-to-host copy and the host tail: VAD post-processing, clustering,
merges):

* an in-memory source ``i + 1`` (an array or an ``(array, sr)`` pair) has
  already been dispatched with :meth:`DiarizationPipeline.stream_start`
  (pinned uploads, the per-chunk programs and the pack, queued on the card
  without waiting for it), so its device work runs under file ``i``'s host
  tail;
* a path source ``i + 1`` is decoded (and resampled) by a host prefetch
  thread.

Two files in flight on one pipeline keep their per-file state apart: each
``stream_start`` returns its own state (its own pinned staging buffers,
SNR probe, pack copy and event), and ``stream_finish`` restores the probe
before the host tail reads it.  A file's segments are those of a lone call.

Failures are per file: each goes into the report's error table with its
exception, and the worker carries on with the next file.  Given an
encoder (``encode_model``), more than one device and fewer files than
devices, file parallelism cannot fill the devices: one pipeline then
spreads each file's window grid over a mesh of all of them
(``parallel/inference.py``) and takes the files in order
(``_corpus_diarize_sharded``), as the JAX package does.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Sequence

from ..config import DiarizationConfig
from ..io.writers import write_rttm
from ..utils.logging import get_logger
from .diarize import DiarizationPipeline

log = get_logger("corpus")


@dataclass
class CorpusReport:
    files: list[dict[str, Any]] = field(default_factory=list)
    errors: list[dict[str, Any]] = field(default_factory=list)
    wall_s: float = 0.0
    audio_s: float = 0.0
    n_devices: int = 1

    @property
    def rtf(self) -> float:
        return self.audio_s / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> dict[str, Any]:
        return {
            "files_ok": len(self.files),
            "files_failed": len(self.errors),
            "audio_s": round(self.audio_s, 1),
            "wall_s": round(self.wall_s, 2),
            "rtf": round(self.rtf, 2),
            "devices": self.n_devices,
        }


def _name(src, idx: int) -> str:
    return str(src) if isinstance(src, (str, Path)) else f"array[{idx}]"


def _file_entry(src, idx: int, result, st: dict, wall_s: float, device: str,
                rttm_dir, keep_results: bool) -> dict:
    """A finished file's report entry (and its RTTM, for a path source)."""
    if rttm_dir is not None and isinstance(src, (str, Path)):
        out = Path(rttm_dir) / (Path(src).stem + ".rttm")
        out.parent.mkdir(parents=True, exist_ok=True)
        write_rttm(out, result.segments, uri=Path(src).stem)
    entry = {"source": _name(src, idx), "index": idx,
             "segments": len(result.segments), "speakers": result.num_speakers,
             "wall_s": round(wall_s, 4), "audio_s": round(st["t"] / st["sr"], 2),
             "device": device}
    if keep_results:
        entry["result"] = result
    return entry


def _error_entry(src, idx: int, e: Exception) -> dict:
    log.warning("corpus file failed: %s (%s)", _name(src, idx), e)
    return {"source": _name(src, idx), "index": idx,
            "error": f"{type(e).__name__}: {e}"}


def corpus_diarize(
    sources: Sequence,
    cfg: DiarizationConfig | None = None,
    devices: Sequence | None = None,
    rttm_dir: str | Path | None = None,
    pipeline_factory=None,
    encode_model=None,
    encode_params=None,
    keep_results: bool = False,
    **pipeline_kwargs,
) -> CorpusReport:
    """Diarize many files: paths, arrays or ``(array, sr)`` pairs.

    ``devices``: one worker per entry (default: the card, or the CPU when
    ``pipeline_kwargs`` say ``device='cpu'``).  ``pipeline_factory()``
    builds a worker's pipeline (e.g. one already loaded); by default each
    worker builds ``DiarizationPipeline(cfg, device=its device,
    **pipeline_kwargs)``.  Every report entry carries the source's
    ``index``; ``keep_results`` also stores the full result (``"result"``)
    so callers can score it.  ``rttm_dir`` gets one RTTM per path source.

    When ``encode_model`` (with ``encode_params``, a flat dict under the
    JAX flat keys, or None for the model's own weights) is given, there is
    more than one device and there are fewer files than devices, each
    file's window grid is sharded over a dp mesh of all ``devices``
    instead (entries' ``"device"``: ``"sharded[n]"``).
    """
    sources = list(sources)
    if devices is None:
        devices = [pipeline_kwargs.pop("device", None)]
    else:
        devices = list(devices)
        pipeline_kwargs.pop("device", None)
    if (encode_model is not None and len(devices) > 1
            and len(sources) < len(devices)):
        return _corpus_diarize_sharded(
            sources, cfg, devices, rttm_dir, encode_model, encode_params,
            keep_results=keep_results, **pipeline_kwargs)
    work: queue.Queue = queue.Queue()
    for i, src in enumerate(sources):
        work.put((i, src))
    report = CorpusReport(n_devices=len(devices))
    lock = threading.Lock()

    def worker(dev) -> None:
        pipe = (pipeline_factory() if pipeline_factory is not None
                else DiarizationPipeline(cfg, device=dev, **pipeline_kwargs))

        def get():
            try:
                return work.get_nowait()
            except queue.Empty:
                return None

        def start(idx, src, decoded=None):
            """-> (idx, src, state or the exception that stopped it)."""
            try:
                return idx, src, pipe.stream_start(src if decoded is None
                                                   else decoded)
            except Exception as e:  # noqa: BLE001 - reported with its file
                return idx, src, e

        def decode(item):
            idx, src = item
            try:
                return idx, src, pipe._host_array(src)
            except Exception as e:  # noqa: BLE001 - reported with its file
                return idx, src, e

        with ThreadPoolExecutor(1) as prefetcher:
            item = get()
            cur = None if item is None else start(*item)
            while cur is not None:
                nxt = get()
                fut = ready = None
                if nxt is not None:
                    if isinstance(nxt[1], (str, Path)):
                        fut = prefetcher.submit(decode, nxt)
                    else:
                        ready = start(*nxt)     # dispatched before cur finishes
                idx, src, st = cur
                try:
                    if isinstance(st, Exception):
                        raise st
                    t0 = time.perf_counter()
                    result = pipe.stream_finish(st)
                    entry = _file_entry(src, idx, result, st,
                                        time.perf_counter() - t0, str(pipe.device),
                                        rttm_dir, keep_results)
                    with lock:
                        report.files.append(entry)
                        report.audio_s += entry["audio_s"]
                except Exception as e:  # noqa: BLE001 - the error table
                    with lock:
                        report.errors.append(_error_entry(src, idx, e))
                if fut is not None:
                    n_idx, n_src, y = fut.result()
                    cur = ((n_idx, n_src, y) if isinstance(y, Exception)
                           else start(n_idx, n_src, y))
                else:
                    cur = ready

    t0 = time.perf_counter()
    if len(devices) == 1:
        worker(devices[0])
    else:
        # a worker that cannot start (its pipeline does not build) stops the
        # corpus: its exception is raised here, after every thread joined
        failures = []

        def run(dev) -> None:
            try:
                worker(dev)
            except Exception as e:  # noqa: BLE001 - re-raised below
                failures.append(e)

        threads = [threading.Thread(target=run, args=(d,)) for d in devices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if failures:
            raise failures[0]
    report.wall_s = time.perf_counter() - t0
    log.info("corpus done: %s", report.summary())
    return report


def _corpus_diarize_sharded(sources: Sequence, cfg: DiarizationConfig | None,
                            devices: Sequence, rttm_dir, encode_model,
                            encode_params, keep_results: bool = False,
                            **pipeline_kwargs) -> CorpusReport:
    """Few files, many devices: one pipeline whose window grid is sharded
    over a dp mesh spanning ``devices`` (on its first device), the files
    one after the other, failures per file."""
    from ..parallel.inference import make_sharded_encode_fn
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(devices=devices)
    encoder = make_sharded_encode_fn(encode_model, encode_params, mesh)
    pipe = DiarizationPipeline(cfg, encoder=encoder, device=mesh.first,
                               **pipeline_kwargs)
    report = CorpusReport(n_devices=len(devices))
    t0 = time.perf_counter()
    for idx, src in enumerate(sources):
        try:
            ts = time.perf_counter()
            st = pipe.stream_start(src)
            result = pipe.stream_finish(st)
            entry = _file_entry(src, idx, result, st, time.perf_counter() - ts,
                                f"sharded[{len(devices)}]", rttm_dir, keep_results)
            report.files.append(entry)
            report.audio_s += entry["audio_s"]
        except Exception as e:  # noqa: BLE001 - the error table
            report.errors.append(_error_entry(src, idx, e))
    report.wall_s = time.perf_counter() - t0
    log.info("corpus (sharded single-file mode) done: %s", report.summary())
    return report

"""How ``correct`` is decided.

Once the window has closed, a sample of the files it completed, drawn from
the seed over the whole window (:class:`~.traffic.CheckSample`), goes
through the reference: the
frozen float32 copy of the pipeline in ``perfbench/reference``, built from
the same weights, on the same waveforms.  Each number below is the worst
over the sample, and each has a limit of its own (``limits/<cell>.json``):

* ``vad_gap``: the largest gap of a VAD probability (the log-mel front end,
  kernel K2, and the VAD net).
* ``energy_gap``: the largest gap of a frame energy, in dB (loudness, DC,
  pre-emphasis on the device).
* ``emb_gap``: the largest distance between a window embedding of the grid
  and the reference's, over the larger of that embedding's norm and the
  median norm (the encoder; kernel K1 in the ECAPA configurations).
* ``fbank_gap``: the largest gap of the windowed grid's log-mel features
  (kernel K2's batch entry), and ``enc_step_gap``: the reference encoder
  net on the program's own features against the program's outputs, as
  ``emb_gap`` measures them (an encoder of the windowed grid, whose
  random-weight net turns the features' rounding into ``emb_gap`` readings
  as large as the control's; the stage is followed step by step from its
  input, which ``fbank_gap`` holds), and ``stitch_mismatch``, exact: the
  net's outputs, batch after batch, must be the result's window embeddings
  row for row (the grid's window order and assembly).
* ``det_gap``: the largest gap of the overlap detector's head logits.
* ``enh_gap``: the enhanced waveform's distance over the reference's norm
  (where the enhancement front-end engages).
* ``tail_mismatch``: exact.  The reference's host tail (VAD post, SCD,
  segment embeddings, clustering, refine, merges, overlap rescue) run on the
  program's own device outputs must give the program's speech and final
  segments to the bit, and the route (streamed or whole-file, enhancer) must
  be the reference's.  The host tail follows the program's own outputs
  because its decisions amplify rounding; the outputs it starts from are
  held to the reference by the numbers above.

The outputs are caught by :class:`Capture`, wrappers on the pipeline
instance (``stream_start``, ``stream_finish``, ``enhance_fn``) and on its
module's ``vad_segments_from_probs`` and ``detect_overlap_regions``, on the
detector net's ``logits`` and on a windowed encoder net's ``forward``, and
from the returned ``DiarizationResult`` (``vad_probs``,
``window_embeddings``, ``overlap_regions``, the segments).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

NUMBERS = ("vad_gap", "energy_gap", "emb_gap", "fbank_gap", "enc_step_gap",
           "stitch_mismatch", "det_gap", "enh_gap", "tail_mismatch")


class Capture:
    """Per-file outputs of one pipeline, for the submissions in ``keep``."""

    def __init__(self, pipe, keep):
        self.pipe = pipe
        self.mod = sys.modules[type(pipe).__module__]
        self.keep = set(keep)
        self.cur = None
        self.by_src: dict[int, int] = {}
        self._st: dict[int, int | None] = {}
        self.vad_args: dict[int, tuple] = {}
        self.enhanced: dict[int, torch.Tensor] = {}
        self.regions: dict[int, object] = {}
        self.det_logits: dict[int, list] = {}
        self.enc_io: dict[int, list] = {}
        self._undo: list = []
        self._wrap(pipe, "stream_start", self._start)
        self._wrap(pipe, "stream_finish", self._finish)
        if getattr(pipe, "enhance_fn", None) is not None:
            self._wrap(pipe, "enhance_fn", self._enhance)
        self._wrap(self.mod, "vad_segments_from_probs", self._vad_post)
        self._wrap(self.mod, "detect_overlap_regions", self._detect)
        seg = pipe._overlap_seg() if pipe.cfg.overlap.enabled else None
        if seg is not None:
            self._wrap(seg.net, "logits", self._keep_out(self.det_logits))
        enc = pipe.encoder
        if not hasattr(enc, "encode_grid_feats") and hasattr(enc, "net"):
            # an encoder of the windowed grid: its net's features and output
            self._wrap(enc.net, "forward", self._keep_io(self.enc_io))

    def _wrap(self, obj, attr, make):
        orig = getattr(obj, attr)
        had = attr in getattr(obj, "__dict__", {})
        setattr(obj, attr, make(orig))
        self._undo.append((obj, attr, orig, had))

    def admit(self, k: int, sample) -> None:
        """Offer submission ``k`` to ``sample`` before it runs; drop the
        outputs of the submissions it no longer keeps."""
        _, gone = sample.admit(k)
        self.keep = sample.kept
        for j in gone:
            for store in (self.vad_args, self.enhanced, self.regions, self.det_logits,
                          self.enc_io):
                store.pop(j, None)

    def release(self) -> None:
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo.clear()

    def _start(self, orig):
        def stream_start(source):
            prev, self.cur = self.cur, self.by_src.get(id(source))
            try:
                st = orig(source)
            finally:
                k, self.cur = self.cur, prev
            self._st[id(st)] = k
            return st
        return stream_start

    def _finish(self, orig):
        def stream_finish(st):
            self.cur = self._st.pop(id(st), None)
            try:
                return orig(st)
            finally:
                self.cur = None
        return stream_finish

    def _enhance(self, orig):
        def enhance_fn(y):
            out = orig(y)
            if self.cur in self.keep:
                self.enhanced[self.cur] = out
            return out
        return enhance_fn

    def _vad_post(self, orig):
        def vad_segments_from_probs(probs, cfg=None, frame_energy_db=None):
            if self.cur in self.keep:
                self.vad_args[self.cur] = (
                    np.array(probs, np.float32, copy=True),
                    None if frame_energy_db is None
                    else np.array(frame_energy_db, np.float32, copy=True))
            return orig(probs, cfg, frame_energy_db=frame_energy_db)
        return vad_segments_from_probs

    def _keep_out(self, store):
        def make(orig):
            def call(*a, **k):
                out = orig(*a, **k)
                if self.cur in self.keep:
                    store.setdefault(self.cur, []).append(out)
                return out
            return call
        return make

    def _keep_io(self, store):
        def make(orig):
            def call(x, *a, **k):
                out = orig(x, *a, **k)
                if self.cur in self.keep:
                    store.setdefault(self.cur, []).append((x, out))
                return out
            return call
        return make

    def _detect(self, orig):
        def detect_overlap_regions(*a, **k):
            out = orig(*a, **k)
            if self.cur in self.keep:
                self.regions[self.cur] = out
            return out
        return detect_overlap_regions


@dataclass
class FileOut:
    """What one run of one file produced, on the host."""
    result: object
    probs: np.ndarray | None
    energy: np.ndarray | None
    embs: np.ndarray | None
    enhanced: np.ndarray | None
    route: tuple
    regions: object
    det: np.ndarray | None = None          # the detector's head logits
    enc_io: list | None = None             # (features, output) per encoder batch

    @classmethod
    def of(cls, result, cap: Capture, k: int) -> "FileOut":
        d = result.diagnostics
        probs, energy = cap.vad_args.get(k, (None, None))
        enh = cap.enhanced.get(k)
        if enh is not None:
            enh = enh.detach().float().cpu().numpy()
        route = (d.get("route"), d.get("enhancer"))
        regions = d.get("overlap_regions", cap.regions.get(k))
        det = io = None
        if cap.det_logits.get(k):
            det = np.concatenate([t.detach().float().reshape(-1, t.shape[-1]).cpu().numpy()
                                  for t in cap.det_logits[k]])
        if cap.enc_io.get(k):
            io = [(x.detach(), y.detach().float().cpu().numpy()) for x, y in cap.enc_io[k]]
        return cls(result, _arr(d.get("vad_probs")), energy,
                   _arr(d.get("window_embeddings")), enh, route, regions, det, io)


def _arr(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _max_gap(a, b) -> float:
    if a is None or b is None or a.shape != b.shape:
        return float("inf")
    if a.size == 0:
        return 0.0
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _emb_gap(p, r) -> float:
    """The largest over the windows of the distance between a window
    embedding and the reference's, over the larger of the reference's norm
    and the median norm."""
    if p is None or r is None or p.shape != r.shape:
        return float("inf")
    if p.size == 0:
        return 0.0
    nr = np.linalg.norm(r, axis=-1)
    den = np.maximum(nr, np.median(nr))
    den = np.where(den > 0, den, 1.0)
    return float(np.max(np.linalg.norm(p - r, axis=-1) / den))


def _segments_equal(a, b) -> int:
    """0 when the two segment arrays are equal to the bit, else the number
    of entries that differ (and the difference of their lengths)."""
    if len(a.starts) != len(b.starts):
        return abs(len(a.starts) - len(b.starts)) + 1
    diff = ((a.starts != b.starts) | (a.ends != b.ends) | (a.spks != b.spks))
    return int(np.count_nonzero(diff))


def tail_mismatch(ref_pipe, prog: FileOut, t: int) -> int:
    """The reference's host tail on the program's device outputs against
    the program's speech and final segments (exact)."""
    mod = sys.modules[type(ref_pipe).__module__]
    cfg = ref_pipe.cfg
    sr = cfg.audio.sample_rate
    if prog.probs is None:
        return 1
    speech = mod.vad_segments_from_probs(prog.probs.astype(np.float32), cfg.vad,
                                         frame_energy_db=prog.energy)
    res = prog.result
    bad = _segments_equal(speech, res.vad_segments)
    if len(speech) == 0:
        return bad + (0 if len(res.segments) == 0 else len(res.segments))
    if prog.embs is None:
        return bad + 1
    starts_s = mod.window_starts(t, sr, cfg.reseg.win_s, cfg.reseg.hop_s) / sr
    embs = np.asarray(prog.result.diagnostics["window_embeddings"])
    out = ref_pipe._segments_from_grid(
        speech, prog.result.diagnostics["vad_probs"], embs, starts_s, t / sr,
        y=None, sr=sr, overlap_regions=prog.regions)
    return bad + _segments_equal(out.segments, res.segments)


def compare(prog: FileOut, ref: FileOut) -> dict[str, float]:
    """The device-side numbers of one file (the tail is apart)."""
    out = {"vad_gap": _max_gap(prog.probs, ref.probs),
           "energy_gap": _max_gap(prog.energy, ref.energy),
           "emb_gap": _emb_gap(prog.embs, ref.embs)}
    if ref.det is not None or prog.det is not None:
        out["det_gap"] = _max_gap(prog.det, ref.det)
    if ref.enc_io is not None or prog.enc_io is not None:
        if prog.enc_io is None or ref.enc_io is None or len(prog.enc_io) != len(ref.enc_io):
            out["fbank_gap"] = float("inf")
        else:
            out["fbank_gap"] = max(_max_gap(p[0].float().cpu().numpy(), r[0].float().cpu().numpy())
                                   for p, r in zip(prog.enc_io, ref.enc_io))
    if ref.enhanced is not None or prog.enhanced is not None:
        if prog.enhanced is None or ref.enhanced is None \
                or prog.enhanced.shape != ref.enhanced.shape:
            out["enh_gap"] = float("inf")
        else:
            den = float(np.linalg.norm(ref.enhanced)) or 1.0
            out["enh_gap"] = float(np.linalg.norm(prog.enhanced - ref.enhanced) / den)
    return out


def encoder_step_gap(ref_pipe, prog: FileOut) -> float | None:
    """The reference encoder's net on the program's own features against
    the program's outputs: the encoder stage followed step by step (its
    input, the features, is held apart by ``fbank_gap``)."""
    if not prog.enc_io:
        return None
    net = ref_pipe.encoder.net
    gaps = []
    with torch.inference_mode():
        for x, y in prog.enc_io:
            r = net(x.to(next(net.parameters()).device)).float().cpu().numpy()
            gaps.append(_emb_gap(y, r))
    return max(gaps)


def stitch_mismatch(prog: FileOut) -> float | None:
    """The windowed grid's assembly, exact: the encoder net's outputs in the
    order the net produced them, against the result's window embeddings.
    -> the number of rows that differ (the whole grid where the shapes
    differ), or None where no encoder net ran."""
    if not prog.enc_io:
        return None
    if prog.embs is None:
        return float("inf")
    out = np.concatenate([y.reshape(-1, y.shape[-1]) for _, y in prog.enc_io])
    if out.shape != prog.embs.shape:
        return float(max(len(out), len(prog.embs)))
    return float(np.count_nonzero(np.any(out.astype(np.float64) != prog.embs, axis=-1)))


def worst(per_file: list[dict[str, float]]) -> dict[str, float]:
    """Gaps: the largest over the files; the tail: the sum."""
    out: dict[str, float] = {}
    for d in per_file:
        for k, v in d.items():
            if k == "tail_mismatch":
                out[k] = out.get(k, 0.0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """-> (every limited number present and within its limit, the table of
    numbers beside their limits)."""
    table = {}
    ok = True
    for name in NUMBERS:
        if name not in limits:
            continue
        v = numbers.get(name)
        lim = limits[name]
        table[name] = {"value": v, "limit": lim}
        if v is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, table

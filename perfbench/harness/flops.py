"""The operations a file needs, for ``mfu_pct``'s numerator.

Counted once per system by ``torch.utils.flop_counter`` over the frozen
reference's networks on the CPU, at small real sizes, and scaled to each
file's own frames and windows: the file's real samples, no chunk padding and
no context the implementation recomputes.  GRUs, which the counter does not
see, are counted by a hook on each ``nn.GRU`` (two operations a
multiply-add, three gates).  The count reads the same whatever implements
the networks.

Each slot of the configuration (``systems.SLOTS``) gives its rates (the
operations a frame, window or sample, from a :class:`Probe`) and its terms
(the file's operations, from its :class:`Geometry`): a block that names a
``kind`` by its kind's file, the VAD and the GTCRN enhancer without one and
the overlap detector here.  A file's total is the VAD's terms, the
encoder's, the enhancer's where the result's route says it engaged, and the
detector's where it ran, added in that order.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import torch
from torch.utils.flop_counter import FlopCounterMode

from .spec import load_kind
from .systems import _path, pipeline_dict

SR = 16000
HOP = 160                      # the 10 ms mel hop
N_F = 400                      # frames of the probe's test wave


def count(fn, root: torch.nn.Module) -> float:
    """The operations of ``fn()``: the flop counter's, and the GRUs' of
    ``root``'s modules."""
    grus = []

    def gru_hook(mod, inp, out):
        x = inp[0]
        b, t = (x.shape[0], x.shape[1]) if mod.batch_first else (x.shape[1], x.shape[0])
        h, n_in = mod.hidden_size, mod.input_size
        dirs = 2 if mod.bidirectional else 1
        total = 0
        for layer in range(mod.num_layers):
            i = n_in if layer == 0 else h * dirs
            total += 2 * 3 * h * (i + h) * b * t * dirs
        grus.append(total)

    hooks = [m.register_forward_hook(gru_hook)
             for m in root.modules() if isinstance(m, torch.nn.GRU)]
    try:
        with torch.inference_mode(), FlopCounterMode(display=False) as fc:
            fn()
    finally:
        for h in hooks:
            h.remove()
    return float(fc.get_total_flops() + sum(grus))


@dataclass
class Probe:
    """What a slot's rates are counted with, on the CPU."""
    cfg: object                 # the reference's pipeline config
    g: torch.Generator          # the test inputs' draws, slot after slot
    y: torch.Tensor             # a test wave of ``n_f`` mel frames
    n_f: int = N_F

    count = staticmethod(count)

    @property
    def win(self) -> int:
        """Samples of a window of the embedding grid."""
        return int(round(self.cfg.reseg.win_s * SR))

    @property
    def hop(self) -> int:
        """Samples between two windows of the embedding grid."""
        return int(round(self.cfg.reseg.hop_s * SR))

    path = staticmethod(_path)


@dataclass
class Geometry:
    """One file as its slots' terms see it."""
    n_samples: int
    n_f: int                    # mel frames at the 10 ms hop
    n_w: int                    # windows of the embedding grid
    streamed: bool              # the streamed route (else the whole-file path)
    vad_logmel: float           # the VAD's own log-mel over the file: an
    #                             encoder's terms add it where it does not
    #                             share it


def _vad_rates(block: dict, probe: Probe) -> dict:
    from ..reference.dsp.mel import log_mel_spectrogram
    from ..reference.models import port

    vad = port.load_vad(_path(block["weights"])).eval()
    r = {"logmel_pf": count(lambda: log_mel_spectrogram(
        probe.y, SR, vad.net.n_mels, vad.win_ms, vad.hop_ms), vad) / probe.n_f}
    feats = torch.randn(probe.n_f, vad.net.n_mels, generator=probe.g)
    r["pf"] = count(lambda: vad.probs_from_feats(feats), vad) / probe.n_f
    return r


def _vad_terms(r: dict, geo: Geometry) -> list[float]:
    return [geo.n_f * r["pf"]]


def _gtcrn_rates(block: dict, probe: Probe) -> dict:
    from ..reference.models import port
    from ..reference.pipelines.enhance import GtcrnEnhancer

    gt = GtcrnEnhancer(port.load_gtcrn(_path(block["weights"])))
    n_s = SR * 2
    wav = 0.1 * torch.randn(1, n_s, generator=probe.g)
    return {"ps": count(lambda: gt.forward(wav), gt.net) / n_s}


def _gtcrn_terms(r: dict, geo: Geometry) -> list[float]:
    return [geo.n_samples * r["ps"]]


_BUILT_IN = {"vad": SimpleNamespace(rates=_vad_rates, terms=_vad_terms),
             "enhancer": SimpleNamespace(rates=_gtcrn_rates, terms=_gtcrn_terms)}


def _slot(config: dict, slot: str, probe: Probe):
    """(terms function, rates) of a slot's block: its kind's, else the
    built-in count (the VAD; the enhancer when its backend is GTCRN); None
    where there is neither."""
    block = config.get(slot)
    if block is None:
        return None
    if "kind" in block:
        mod = load_kind(block["kind"])
    elif slot == "vad" or (slot == "enhancer" and block.get("backend") == "gtcrn"):
        mod = _BUILT_IN[slot]
    else:
        return None
    return mod.terms, mod.rates(block, probe)


def _rates(system) -> dict:
    """Every slot's rates, on the CPU; the draws of their test inputs come
    from one generator in the order VAD, encoder, detector, enhancer."""
    from ..reference.config import config_from_dict

    config = system.config
    cfg = config_from_dict(pipeline_dict(config))
    g = torch.Generator().manual_seed(0)
    probe = Probe(cfg, g, 0.1 * torch.randn(N_F * HOP, generator=g))
    out = {"probe": probe, "vad": _slot(config, "vad", probe),
           "encoder": _slot(config, "encoder", probe)}
    out["vad_logmel_pf"] = out["vad"][1]["logmel_pf"]
    seg_path = config.get("overlap_detector", {}).get("weights")
    if seg_path:
        from ..reference.models import port

        seg = port.load_segmentation(_path(seg_path)).eval()
        w5 = 0.1 * torch.randn(1, int(round(cfg.overlap.chunk_s * SR)), generator=g)
        out["detector_pw"] = count(lambda: seg.hard_activities(w5), seg)
    out["enhancer"] = _slot(config, "enhancer", probe)
    return out


def _add(total: float, slot, geo: Geometry) -> float:
    if slot is not None:
        terms, r = slot
        for t in terms(r, geo):
            total += t
    return total


def file_flops(system, n_samples: int, result) -> float:
    """The operations of one file of ``n_samples`` on the route its result
    names."""
    rates = getattr(system, "_flops_rates", None)
    if rates is None:
        rates = system._flops_rates = _rates(system)
    probe = rates["probe"]
    cfg = probe.cfg
    from ..reference.dsp.framing import num_frames

    d = result.diagnostics
    n_f = n_samples // HOP + 1
    streamed = d.get("route") == "streamed"
    geo = Geometry(n_samples, n_f, num_frames(n_samples, probe.win, probe.hop, pad_tail=True),
                   streamed, n_f * rates["vad_logmel_pf"])
    total = _add(_add(0.0, rates["vad"], geo), rates["encoder"], geo)
    enhanced = d.get("enhancer") is not None
    if enhanced and d["enhancer"] == system.config.get("enhancer", {}).get("backend"):
        total = _add(total, rates["enhancer"], geo)
    detector = (d.get("overlap_hard") is not None) if streamed else (
        cfg.overlap.enabled and not enhanced)
    if detector and "detector_pw" in rates:
        w5 = int(round(cfg.overlap.chunk_s * SR))
        s5 = max(1, int(round(cfg.overlap.chunk_hop_s * SR)))
        n_ov = max(1, -(-max(n_samples - w5, 0) // s5) + 1)
        total += n_ov * rates["detector_pw"]
    return float(total)

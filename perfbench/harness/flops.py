"""The operations a file needs, for ``mfu_pct``'s numerator.

Counted once per system by ``torch.utils.flop_counter`` over the frozen
reference's networks on the CPU, at small real sizes, and scaled to each
file's own frames and windows: the file's real samples, no chunk padding and
no context the implementation recomputes.  GRUs, which the counter does not
see, are counted by a hook on each ``nn.GRU`` (two operations a
multiply-add, three gates).  The count reads the same whatever implements
the networks.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

SR = 16000
HOP = 160                      # the 10 ms mel hop


def _count(fn, root: torch.nn.Module) -> float:
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


def _rates(system) -> dict:
    """Operations per frame, window or sample of each network, on the CPU."""
    from ..reference.config import config_from_dict
    from ..reference.dsp.mel import log_mel_spectrogram
    from ..reference.models import eres2netv2 as eres_mod
    from ..reference.models import port
    from ..reference.pipelines.enhance import GtcrnEnhancer
    from .systems import _path, pipeline_dict

    config = system.config
    cfg = config_from_dict(pipeline_dict(config))
    g = torch.Generator().manual_seed(0)
    rates = {}
    vad = port.load_vad(_path(config["vad"]["weights"])).eval()
    n_f = 400
    y = 0.1 * torch.randn(n_f * HOP, generator=g)
    rates["vad_logmel_pf"] = _count(lambda: log_mel_spectrogram(
        y, SR, vad.net.n_mels, vad.win_ms, vad.hop_ms), vad) / n_f
    feats_v = torch.randn(n_f, vad.net.n_mels, generator=g)
    rates["vad_pf"] = _count(lambda: vad.probs_from_feats(feats_v), vad) / n_f
    e = config["encoder"]
    win = int(round(cfg.reseg.win_s * SR))
    if e["kind"] == "ecapa_npz":
        enc = port.load_speaker_encoder(_path(e["weights"])).eval()
        net = enc.net
        rates["enc_logmel_pf"] = _count(lambda: log_mel_spectrogram(
            y, SR, net.n_mels), enc) / n_f
        feats = torch.randn(1, n_f, net.n_mels, generator=g)
        rates["trunk_pf"] = _count(lambda: net.trunk(feats, se_win=None), enc) / n_f
        x = net.trunk(feats)[0].float()
        win_f, hop_f = win // HOP, int(round(cfg.reseg.hop_s * SR)) // HOP
        n_w = (n_f - win_f) // hop_f + 1
        rates["head_pw"] = _count(lambda: net.asp_head_grid(x, 0, hop_f, win_f, n_w), enc) / n_w
    else:
        enc = eres_mod.ERes2NetV2Model(eres_mod.ERes2NetV2(**e["net"])).eval()
        wav = 0.1 * torch.randn(1, win, generator=g)
        rates["window_pw"] = _count(lambda: enc.encode_batch(wav), enc)
    seg_path = config.get("overlap_detector", {}).get("weights")
    if seg_path:
        seg = port.load_segmentation(_path(seg_path)).eval()
        w5 = 0.1 * torch.randn(1, int(round(cfg.overlap.chunk_s * SR)), generator=g)
        rates["detector_pw"] = _count(lambda: seg.hard_activities(w5), seg)
    if config.get("enhancer", {}).get("backend") == "gtcrn":
        gt = GtcrnEnhancer(port.load_gtcrn(_path(config["enhancer"]["weights"])))
        n_s = SR * 2
        wav = 0.1 * torch.randn(1, n_s, generator=g)
        rates["gtcrn_ps"] = _count(lambda: gt.forward(wav), gt.net) / n_s
    rates["cfg"] = cfg
    return rates


def file_flops(system, n_samples: int, result) -> float:
    """The operations of one file of ``n_samples`` on the route its result
    names."""
    rates = getattr(system, "_flops_rates", None)
    if rates is None:
        rates = system._flops_rates = _rates(system)
    cfg = rates["cfg"]
    from ..reference.dsp.framing import num_frames

    d = result.diagnostics
    n_f = n_samples // HOP + 1
    win = int(round(cfg.reseg.win_s * SR))
    hop = int(round(cfg.reseg.hop_s * SR))
    n_w = num_frames(n_samples, win, hop, pad_tail=True)
    w5 = int(round(cfg.overlap.chunk_s * SR))
    s5 = max(1, int(round(cfg.overlap.chunk_hop_s * SR)))
    n_ov = max(1, -(-max(n_samples - w5, 0) // s5) + 1)
    streamed = d.get("route") == "streamed"
    total = n_f * rates["vad_pf"]
    if "trunk_pf" in rates:
        total += n_f * (rates["trunk_pf"] + rates["enc_logmel_pf"]) + n_w * rates["head_pw"]
        if not streamed:                 # the VAD's own log-mel on the whole-file path
            total += n_f * rates["vad_logmel_pf"]
    else:
        total += n_w * rates["window_pw"] + n_f * rates["vad_logmel_pf"]
    enhanced = d.get("enhancer") is not None
    if enhanced and "gtcrn_ps" in rates:
        total += n_samples * rates["gtcrn_ps"]
    detector = (d.get("overlap_hard") is not None) if streamed else (
        cfg.overlap.enabled and not enhanced)
    if detector and "detector_pw" in rates:
        total += n_ov * rates["detector_pw"]
    return float(total)


"""Model kind ``ecapa_npz``: the streaming ECAPA-TDNN of a shipped ``.npz``
(``weights``), the flagship's speaker encoder, handed to the pipeline as
``encoder``.  Both sides read the same checkpoint; the program's trunk runs
at the configuration's ``precision.encoder_trunk``, the reference's at
float32.

Operations: the encoder's log-mel and trunk a frame and the attentive
statistics head a window of the grid.  On the streamed route the VAD reads
the encoder's log-mel (one K2 launch for both); on the whole-file path the
VAD computes its own, which is counted here.
"""
from __future__ import annotations

import torch

from perfbench.harness.flops import HOP, SR


def build(block, side):
    port = side.module("models.port")
    return port.load_speaker_encoder(side.path(block["weights"]),
                                     dtype=side.dtype("encoder_trunk"))


def rates(block, probe) -> dict:
    from perfbench.reference.dsp.mel import log_mel_spectrogram
    from perfbench.reference.models import port

    enc = port.load_speaker_encoder(probe.path(block["weights"])).eval()
    net = enc.net
    n_f = probe.n_f
    r = {"logmel_pf": probe.count(lambda: log_mel_spectrogram(probe.y, SR, net.n_mels),
                                  enc) / n_f}
    feats = torch.randn(1, n_f, net.n_mels, generator=probe.g)
    r["trunk_pf"] = probe.count(lambda: net.trunk(feats, se_win=None), enc) / n_f
    x = net.trunk(feats)[0].float()
    win_f, hop_f = probe.win // HOP, probe.hop // HOP
    n_w = (n_f - win_f) // hop_f + 1
    r["head_pw"] = probe.count(lambda: net.asp_head_grid(x, 0, hop_f, win_f, n_w),
                               enc) / n_w
    return r


def terms(r, geo) -> list[float]:
    out = [geo.n_f * (r["trunk_pf"] + r["logmel_pf"]) + geo.n_w * r["head_pw"]]
    if not geo.streamed:
        out.append(geo.vad_logmel)
    return out

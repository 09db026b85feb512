"""Model kind ``eres2netv2_seeded``: 3D-Speaker's ERes2NetV2 at the block's
``net`` widths, with weights drawn from the run's seed on the device
(``harness/weights.py``; no checkpoint ships) and loaded on both sides,
handed to the pipeline as ``encoder``.  It runs on the windowed grid.

Operations: the network a window of the grid (its own 80-mel log-mel
included), and the VAD's own log-mel, which it never shares.
"""
from __future__ import annotations

import torch


def build(block, side):
    mod = side.module("models.eres2netv2")
    model = mod.ERes2NetV2Model(mod.ERes2NetV2(**block["net"]))
    model.net.load_state_dict(side.seeded_state(model.net))
    return model


def rates(block, probe) -> dict:
    from perfbench.reference.models import eres2netv2 as mod

    enc = mod.ERes2NetV2Model(mod.ERes2NetV2(**block["net"])).eval()
    wav = 0.1 * torch.randn(1, probe.win, generator=probe.g)
    return {"window_pw": probe.count(lambda: enc.encode_batch(wav), enc)}


def terms(r, geo) -> list[float]:
    return [geo.n_w * r["window_pw"] + geo.vad_logmel]

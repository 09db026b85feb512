"""Model kind ``htdemucs_seeded``: the demix-dialog front-end over an
ensemble of ``nets`` Hybrid Transformer Demucs separators at the block's
``net`` widths, handed to the pipeline as ``enhance_fn``.  No checkpoint
ships: net ``i`` is drawn on the device by ``harness/weights.py`` from a seed
derived from the run's seed and ``i``, so the nets differ from each other
and both sides load the same ones.

The program's side is the port's ``make_enhance_fn("demix-dialog",
nets=...)`` over its ``HTDemucsRef``; the reference's is
``reference/pipelines/demix_dialog.py`` over ``reference/models/htdemucs.py``.

Operations: a file's 10 s chunks at 44.1 kHz (at the front-end's overlap,
over the file's real length) times the nets times one chunk's count, which
is taken over the reference network at a whole chunk (attention does not
scale linearly with the length) on the ``meta`` device, so nothing is
computed.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.harness.weights import seeded_state_dict_on_device
from perfbench.reference.pipelines.demix_dialog import DEMIX_SR, SR

OVERLAP = 0.25                     # the front-end's default chunk overlap


def net_seed(seed: int, i: int) -> int:
    """The seed of net ``i`` of a run seeded ``seed``."""
    return int(np.random.SeedSequence([int(seed), 7207, i]).generate_state(
        1, np.uint64)[0] >> 1)


def draws(block: dict, seed: int, device) -> list[dict]:
    """The state_dicts of the ensemble's nets for the run's ``seed``."""
    from perfbench.reference.models.htdemucs import HTDemucs

    with torch.device("meta"):
        manifest = {k: tuple(v.shape) for k, v in HTDemucs(**block["net"]).state_dict().items()}
    return [seeded_state_dict_on_device(manifest, net_seed(seed, i), device)
            for i in range(int(block["nets"]))]


def build(block, side):
    states = draws(block, side.system.seed, side.device)
    if side.program:
        cls = side.module("models.demucs_ref").HTDemucsRef
    else:
        cls = side.module("models.htdemucs").HTDemucs
    nets = []
    for state in states:
        with torch.device(side.device):
            net = cls(**block["net"])
        net.load_state_dict(state)
        nets.append(net)
    if side.program:
        return side.module("pipelines.enhance").make_enhance_fn(
            "demix-dialog", device=side.device, nets=nets, overlap=OVERLAP)
    return side.module("pipelines.demix_dialog").DemixDialog(nets, side.device,
                                                             overlap=OVERLAP)


def rates(block, probe) -> dict:
    from perfbench.reference.models.htdemucs import HTDemucs

    net = block["net"]
    chunk = int(net.get("segment", 10.0) * DEMIX_SR)
    with torch.device("meta"):
        model = HTDemucs(**net).eval()
        mix = torch.empty(1, net.get("audio_channels", 2), chunk)
    return {"chunk": chunk, "nets": int(block["nets"]),
            "per_chunk": probe.count(lambda: model(mix), model)}


def terms(r, geo) -> list[float]:
    t = -(-geo.n_samples * DEMIX_SR // SR)             # samples at 44.1 kHz
    chunk = r["chunk"]
    hop = int(chunk * (1.0 - OVERLAP))
    n = 1 if t <= chunk else 1 + math.ceil((t - chunk) / hop)
    return [n * r["nets"] * r["per_chunk"]]

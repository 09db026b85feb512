"""The port's training driver (``scripts/torch_train_mc.py`` ->
``train/mc.py``) on the CPU: each subcommand runs one step at a small size
with ``--cpu`` and writes an npz that the JAX package's loaders read, with
the key set of the JAX net's own init (and the port's loaders read it
back); without ``--cpu`` and without a card the driver refuses rather than
training on the CPU."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu_torch.models import port
from speech_diarization_tpu_torch.train.mc import main

SMALL = ["--steps", "1", "--batch", "2", "--cpu"]
KEY = jax.random.PRNGKey(0)        # key sets by shape: eval_shape of the inits


def run(tmp_path, what, *extra):
    out = tmp_path / f"{what}.npz"
    assert main([what, *SMALL, "--out", str(out), *extra]) == 0
    return out


def test_vad(tmp_path):
    out = run(tmp_path, "vad")
    jmodel, jparams = jrec.load_vad(out)
    assert set(jrec._flatten(jparams)) == set(jrec._flatten(
        jax.eval_shape(jmodel.init, KEY)))
    assert port.load_vad(out).net.channels == 96


def test_segmentation_powerset_xf(tmp_path):
    out = run(tmp_path, "segmentation", "--powerset", "--seg-arch", "xf",
              "--seg-ds", "3", "--seg-channels", "16", "--seg-hidden", "16",
              "--seg-xf", "1", "--seg-heads", "2", "--seg-conv-frac", "0.5",
              "--overlap-weight", "2")
    jmodel, jparams = jrec.load_segmentation(out)
    assert jmodel.net.powerset and jmodel.net.arch == "xf"
    assert set(jparams) == set(jax.eval_shape(jmodel.init, KEY))
    assert port.load_segmentation(out).net.n_out == 8


def test_encoders(tmp_path):
    out = run(tmp_path, "encoder", "--cold", "--cache", "4", "--speakers", "3")
    jmodel, jparams = jrec.load_speaker_encoder(out)
    assert jmodel.streaming_trained
    with np.load(out) as z:
        assert z["classifier"].shape == (3, jmodel.net.emb_dim)
    ref = jrec._flatten(jax.eval_shape(jmodel.init, KEY))
    assert set(jrec._flatten(jparams)) == set(ref)
    assert port.load_speaker_encoder(out).streaming_trained
    # a warm start from that file keeps its classifier when the sizes agree
    out2 = run(tmp_path, "encoder", "--src", str(out), "--cache", "4",
               "--speakers", "3")
    assert port.load_speaker_encoder(out2).net.channels == jmodel.net.channels


def test_enhancers(tmp_path):
    from speech_diarization_tpu.models.gtcrn import gtcrn_init_params

    out = run(tmp_path, "gtcrn", "--cold")
    with np.load(out) as z:
        assert set(z.files) == set(jax.eval_shape(gtcrn_init_params, KEY))
    port.load_gtcrn(out)
    out = run(tmp_path, "demix", "--demix-channels", "8", "--demix-depth", "2")
    model, params = jrec.load_demixer(out)
    assert model.c == 8 and set(params) == set(jax.eval_shape(model.init, KEY))
    assert port.load_demixer(out).depth == 2


def test_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["vad", "--steps", "1", "--out", str(tmp_path / "x.npz")])

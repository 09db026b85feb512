"""The training slice as a whole, the VAD's half: the port's
``train_vad_synthetic`` against the JAX package's, run end to end for 3
steps from the same initial weights (the shipped conv TCN at its width,
Adam, batches from the recipe's generator in both).

Bars: the losses of steps 1-3 within rtol 1e-4; the port's exported npz
loads with the JAX ``load_vad`` and gives the port's probabilities within
1e-5, and the JAX export loads in the port and gives the JAX
probabilities within 1e-5.  The proto recipe's run is in
``test_torch_train_slice.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu_torch.models.port import load_vad
from speech_diarization_tpu_torch.train import recipes as trec

torch.set_num_threads(2)


def test_vad_recipe_three_steps(tmp_path):
    from speech_diarization_tpu.models.vad import VadConvNet, VadModel

    params = jax.jit(VadModel(VadConvNet()).init)(jax.random.PRNGKey(0))
    kw = dict(steps=3, batch=2, dur_s=2.0, lr=1e-3, seed=7, eval_every=1,
              arch="conv")
    jp, jm = jrec.train_vad_synthetic(**kw, init_params=params,
                                      out_path=tmp_path / "jax.npz")
    tm, tmet = trec.train_vad_synthetic(**kw, init_params=jrec._flatten(params),
                                        out_path=tmp_path / "port.npz",
                                        device="cpu")
    np.testing.assert_allclose(tmet["loss"], jm["loss"], rtol=1e-4)
    wave = np.random.default_rng(1).standard_normal(24000).astype(np.float32) * 0.1
    with torch.no_grad():
        mine = tm.probs(torch.from_numpy(wave)).numpy()
    jmodel, jparams = jrec.load_vad(tmp_path / "port.npz")
    np.testing.assert_allclose(np.asarray(jmodel.probs(jparams, jnp.asarray(wave))),
                               mine, atol=1e-5)
    with torch.no_grad():
        theirs = load_vad(tmp_path / "jax.npz").probs(torch.from_numpy(wave)).numpy()
    jmodel, jparams = jrec.load_vad(tmp_path / "jax.npz")
    np.testing.assert_allclose(
        theirs, np.asarray(jmodel.probs(jparams, jnp.asarray(wave))), atol=1e-5)

"""The training slice as a whole: the port's proto recipe (the default
encoder's) against the JAX package's, run end to end for 3 steps from the
same initial weights (the VAD recipe's run is in
``test_torch_train_vad.py``).

* ``train_speaker_encoder_proto`` (a small streaming ECAPA, the angular
  prototypical loss over a rendered pool refreshed after step 2, competing
  speakers, Adam): the losses of steps 1-3 within rtol 1e-4 (the same
  draws from the recipe's generator in both, so a drift in the batches or
  the pool shows here too), the unseen-speaker probe within 1e-4;
* the port's exported npz loads with the JAX ``load_speaker_encoder`` and
  gives the port's own grid embeddings (decomposed head) within 1e-5; the
  JAX export loads in the port.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu.train.proto import train_speaker_encoder_proto as j_proto
from speech_diarization_tpu_torch.models.port import load_speaker_encoder
from speech_diarization_tpu_torch.train.proto import train_speaker_encoder_proto as t_proto

torch.set_num_threads(2)
SMALL = dict(n_mels=40, channels=32, emb_dim=16, scale=4, se_channels=8,
             att_channels=8)


def test_proto_recipe_three_steps(tmp_path, monkeypatch):
    from speech_diarization_tpu.models.ecapa import EcapaModel, EcapaTdnn
    from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn as TEcapa

    # the JAX recipe's probes run the grid encoder eagerly (some 190 small
    # compiles, half of this test's time on the CPU): the same function
    # under jit
    grid = jax.jit(EcapaModel.encode_grid_chunk, static_argnums=(0, 3, 4, 5, 6),
                   static_argnames=("backend",))
    monkeypatch.setattr(EcapaModel, "encode_grid_chunk",
                        lambda self, p, y, n, m, w, h, backend=None:
                        grid(self, p, y, n, m, w, h, backend=backend))

    params = jax.jit(EcapaModel(EcapaTdnn(**SMALL)).init)(jax.random.PRNGKey(1))
    kw = dict(steps=3, spk_per_batch=3, utt_per_spk=2, seed=5, pool_speakers=6,
              pool_utts=2, pool_refresh_steps=2, dur_s=1.5, log_every=1,
              competing_p=0.5)
    _, jm = j_proto(**kw, net=EcapaTdnn(**SMALL), init_params=dict(params),
                    out_path=tmp_path / "jax.npz")
    tm, tmet = t_proto(**kw, net=TEcapa(**SMALL),
                       init_params=jrec._flatten(params),
                       out_path=tmp_path / "port.npz", device="cpu")
    np.testing.assert_allclose(tmet["loss"], jm["loss"], rtol=1e-4)
    np.testing.assert_allclose(tmet["unseen_separation"],
                               jm["unseen_separation"], atol=1e-4)
    wave = np.random.default_rng(2).standard_normal(40000).astype(np.float32) * 0.1
    with torch.no_grad():
        mine = tm.encode_grid_chunk(torch.from_numpy(wave), 5, 0, 16000, 4000,
                                    backend="decomposed").numpy()
    jmodel, jparams = jrec.load_speaker_encoder(tmp_path / "port.npz")
    assert jmodel.streaming_trained
    ref = np.asarray(jax.jit(lambda p, y: jmodel.encode_grid_chunk(
        p, y, 5, 0, 16000, 4000, backend="decomposed"))(jparams, jnp.asarray(wave)))
    np.testing.assert_allclose(mine, ref, atol=1e-5)
    back = load_speaker_encoder(tmp_path / "jax.npz")
    assert back.streaming_trained and back.net.channels == SMALL["channels"]

"""The windowed speaker-encoder recipe (``train_speaker_encoder_synthetic``,
per-utterance embeddings through ``encode_batch``) against the JAX
package's: step 1 from the same JAX init, and the driver's
``encoder-windowed`` subcommand on the CPU, whose npz the JAX loader reads.

Bars as in ``test_torch_train_encoders.py`` (its ``compare_grads``): loss
rtol 1e-4, every gradient leaf within 1e-4 of its largest magnitude, or of
1e-3 of the largest gradient of all where the leaf's nearly cancels.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from speech_diarization_tpu.models.ecapa import EcapaModel, EcapaTdnn
from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu.train.objectives import aam_softmax_loss
from speech_diarization_tpu.train.synthetic import make_speaker_bank, make_speaker_batch
from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn as TEcapa
from speech_diarization_tpu_torch.train import recipes as trec
from speech_diarization_tpu_torch.train.mc import main

torch.set_num_threads(2)
SMALL = dict(n_mels=40, channels=32, emb_dim=16, scale=4, se_channels=8,
             att_channels=8)


def jax_init(seed, n_classes=None):
    model = EcapaModel(EcapaTdnn(**SMALL))
    params = jax.jit(model.init)(jax.random.PRNGKey(seed))
    if n_classes:
        params["classifier"] = 0.05 * jax.random.normal(
            jax.random.PRNGKey(seed + 100), (n_classes, SMALL["emb_dim"]))
    return model, params


def compare_grads(params_t, loss_t, val_j, grads_j):
    """Loss and every gradient leaf, each within 1e-4 of its largest
    magnitude, or of 1e-3 of the largest gradient of all where the leaf's is
    smaller: a gradient that cancels to rounding noise (``att_b2`` and
    ``proto_bias`` shift logits alike, which the softmax cancels exactly;
    ``att_bn``'s mean and shift meet the softmax after a tanh and nearly
    cancel, about 1e-6 of the largest).  A leaf the loss does not reach (the
    running statistics under train-mode BN) has no grad in torch and a zero
    one in JAX."""
    np.testing.assert_allclose(loss_t.item(), float(val_j), rtol=1e-4)
    g_j = jrec._flatten(grads_j)
    assert set(params_t) == set(g_j)
    top = max(float(np.abs(np.asarray(g)).max()) for g in g_j.values())
    for k, p in params_t.items():
        ref = np.asarray(g_j[k])
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        bar = 1e-4 * max(np.abs(ref).max(), 1e-3 * top)
        assert np.abs(got - ref).max() <= bar, (k, np.abs(got - ref).max(), bar)


def test_windowed_recipe_step():
    model, params = jax_init(1, n_classes=4)
    rng = np.random.default_rng(3)
    bank = make_speaker_bank(rng, 4)
    wavs, labels = make_speaker_batch(rng, bank, 3)

    def jloss(p, wavs, labels):
        return aam_softmax_loss(model.encode_batch(p, wavs), p["classifier"],
                                labels)

    val_j, g_j = jax.jit(jax.value_and_grad(jloss))(
        params, jnp.asarray(wavs), jnp.asarray(labels))
    job = trec.speaker_encoder_job(batch=3, n_speakers=4, seed=3,
                                   net=TEcapa(**SMALL),
                                   init_params=jrec._flatten(params),
                                   device="cpu")
    batch = job.next_batch()
    assert batch[0].tobytes() == wavs.tobytes()
    loss = job.loss_fn(*job.batch_tensors(batch))
    loss.backward()
    compare_grads(job.state.params, loss, val_j, g_j)


def test_windowed_driver(tmp_path):
    out = tmp_path / "windowed.npz"
    assert main(["encoder-windowed", "--cpu", "--cold", "--steps", "1",
                 "--batch", "2", "--cache", "4", "--speakers", "3",
                 "--out", str(out)]) == 0
    jmodel, jparams = jrec.load_speaker_encoder(out)
    assert not jmodel.streaming_trained and jmodel.net.channels == 128

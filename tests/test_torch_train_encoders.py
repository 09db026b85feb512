"""Step 1 of the port's speaker-encoder training against the JAX package's:
the streaming recipe (``train_speaker_encoder_streaming``, through an
utterance cache), the proto recipe's loss, and ``make_ecapa_train_step``
with train-mode BatchNorm (the windowed recipe is in
``test_torch_train_windowed.py``).

Both packages start from the same JAX ``init`` (BatchNorm statistics and
the classifier included) on a small ECAPA; bars as in
``test_torch_train_recipes.py``: loss rtol 1e-4, every gradient leaf within
1e-4 of its largest magnitude.  The streaming and proto losses go through
one batched trunk pass and the decomposed grid head in the port, a ``vmap``
of ``encode_grid_chunk(..., backend='decomposed')`` in the JAX package.
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


def test_streaming_recipe_step():
    model, params = jax_init(0, n_classes=3)
    dur_s, win, hop, cache = 1.5, 16000, 8000, 6
    n_win = (int(dur_s * 16000) - win) // hop + 1
    # the JAX recipe's draws: bank, cache, then one cached batch
    rng = np.random.default_rng(2)
    bank = make_speaker_bank(rng, 3)
    cw, cl = make_speaker_batch(rng, bank, cache, dur_s=dur_s,
                                preprocess_aug=False)
    idx = rng.integers(0, len(cw), size=2)
    ws = cw[idx].copy()
    for i in range(2):
        if rng.uniform() < 0.5:
            ws[i, 1:] = ws[i, 1:] - 0.97 * ws[i, :-1]
        ws[i] = np.clip(ws[i] * 10.0 ** (rng.uniform(-12.0, 6.0) / 20.0),
                        -0.99, 0.99)
    labels = cl[idx]

    def jloss(p, wavs, labels):
        embs = jax.vmap(lambda y: model.encode_grid_chunk(
            p, y, n_win, 0, win, hop, backend="decomposed"))(wavs)
        return aam_softmax_loss(embs.reshape(-1, embs.shape[-1]),
                                p["classifier"], jnp.repeat(labels, n_win))

    val_j, g_j = jax.jit(jax.value_and_grad(jloss))(
        params, jnp.asarray(ws), jnp.asarray(labels))
    job = trec.stream_encoder_job(batch=2, n_speakers=3, seed=2,
                                  net=TEcapa(**SMALL), utterance_cache=cache,
                                  dur_s=dur_s, init_params=jrec._flatten(params),
                                  device="cpu")
    wavs_t, labels_t = job.next_batch()
    assert wavs_t.tobytes() == ws.tobytes() and (labels_t == labels).all()
    loss = job.loss_fn(*job.batch_tensors((wavs_t, labels_t)))
    loss.backward()
    compare_grads(job.state.params, loss, val_j, g_j)


def test_proto_recipe_step():
    from speech_diarization_tpu.train.proto import angular_proto_loss
    from speech_diarization_tpu_torch.train.proto import proto_job

    model, params = jax_init(2)
    params["proto_scale"] = jnp.asarray(10.0)
    params["proto_bias"] = jnp.asarray(-5.0)
    job = proto_job(spk_per_batch=3, utt_per_spk=2, seed=4, net=TEcapa(**SMALL),
                    init_params=jrec._flatten(params), pool_speakers=6,
                    pool_utts=2, dur_s=1.5, hard_pair_frac=0.7, device="cpu")
    (wavs,) = job.next_batch()
    assert wavs.shape == (3, 2, 24000)
    win, hop = 16000, 8000
    n_win = (24000 - win) // hop + 1

    def jloss(p, wavs):
        flat = wavs.reshape(-1, wavs.shape[-1])
        embs = jax.vmap(lambda y: model.encode_grid_chunk(
            p, y, n_win, 0, win, hop, backend="decomposed"))(flat)
        e = embs / (jnp.linalg.norm(embs, axis=-1, keepdims=True) + 1e-9)
        return angular_proto_loss(e.mean(axis=1).reshape(3, 2, -1),
                                  p["proto_scale"], p["proto_bias"])

    val_j, g_j = jax.jit(jax.value_and_grad(jloss))(params, jnp.asarray(wavs))
    loss = job.loss_fn(*job.batch_tensors((wavs,)))
    loss.backward()
    compare_grads(job.state.params, loss, val_j, g_j)


def test_ecapa_train_step_batch_stats():
    from speech_diarization_tpu.dsp.mel import fbank_batch
    from speech_diarization_tpu_torch.train.steps import make_ecapa_train_step

    # train-mode BN over 4 utterances is ill-conditioned (a 1e-7 change of
    # the features moves some gradients by 5 %); over 16 by about 1e-5
    model, params = jax_init(3, n_classes=5)
    net = model.net
    rng = np.random.default_rng(5)
    wavs, labels = make_speaker_batch(rng, make_speaker_bank(rng, 5), 16,
                                      dur_s=1.0)

    def jloss(p, wavs, labels):
        feats = fbank_batch(wavs, sample_rate=16000, n_mels=net.n_mels)
        return aam_softmax_loss(net.apply(p, feats, train=True),
                                p["classifier"], labels)

    val_j, g_j = jax.jit(jax.value_and_grad(jloss))(
        params, jnp.asarray(wavs), jnp.asarray(labels))
    tnet = TEcapa(**SMALL)
    init_fn, step_fn, shard_state = make_ecapa_train_step("cpu", tnet, 5)
    state = shard_state(init_fn(params=jrec._flatten(params)))
    loss = step_fn.loss_fn(state.params, torch.from_numpy(wavs),
                           torch.from_numpy(labels))
    loss.backward()
    compare_grads(state.params, loss, val_j, g_j)
    # the running statistics do not enter train-mode BN: no gradient there
    assert state.params["stem/bn_mean"].grad is None
    # a step moves them all the same (AdamW's decay reaches every leaf)
    before = state.params["stem/bn_var"].detach().clone()
    state, loss2 = step_fn(state, wavs, labels)
    assert state.step == 1 and np.isfinite(loss2.item())
    assert not torch.equal(before, state.params["stem/bn_var"])

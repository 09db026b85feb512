"""GTCRN training against the JAX package's, the training checkpoint, and
the kernels' refusal of autograd.

* Step 1 of ``train_gtcrn_synthetic`` and of ``make_gtcrn_train_step`` on
  the recipe's first batch, from the same JAX init: loss rtol 1e-4, every
  gradient leaf (BatchNorm statistics and the ERB filterbank included)
  within 1e-4 of its largest magnitude.
* ``save_train_state`` / ``restore_train_state``: the file reads with
  ``weights_only=True``; a run restored at step 2 takes step 3 exactly as
  the uninterrupted run does (Adam's moments and step count, the cosine
  schedule's count).
* ``export_inference_weights``: the npz has the JAX recipe's keys and
  ``__meta__`` and loads in both packages.
* ``kernels.refuse_autograd``: raises on an input that requires grad while
  autograd records, and only then; the K1 head refuses a batch of chunks.
* The device constants of the STFT and the sliding mean, first made under
  ``torch.inference_mode()`` (a pipeline's call), still serve a backward.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu.train.objectives import si_snr_loss
from speech_diarization_tpu_torch.ops import kernels
from speech_diarization_tpu_torch.train import recipes as trec
from speech_diarization_tpu_torch.train.checkpoint import (
    export_inference_weights, restore_train_state, save_train_state,
)

torch.set_num_threads(2)


def test_gtcrn_recipe_and_step():
    from speech_diarization_tpu.dsp.stft import istft_ri, stft_ri
    from speech_diarization_tpu.models.gtcrn import GTCRN, gtcrn_init_params
    from speech_diarization_tpu_torch.train.steps import make_gtcrn_train_step

    net = GTCRN()
    params = jax.jit(gtcrn_init_params)(jax.random.PRNGKey(2))
    batch = jrec.make_noisy_clean_batch(np.random.default_rng(5), 2, 1.0)

    def jloss(p, noisy, clean):
        spec = stft_ri(noisy, 512, 256)
        wav = istft_ri(net.apply(p, spec), 512, 256, length=noisy.shape[-1])
        return si_snr_loss(wav, clean)

    val_j, g_j = jax.jit(jax.value_and_grad(jloss))(
        params, *(jnp.asarray(b) for b in batch))
    flat = {k: np.asarray(v) for k, v in params.items()}
    job = trec.gtcrn_job(batch=2, dur_s=1.0, seed=5, init_params=flat,
                         device="cpu")
    got = job.next_batch()
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, batch))
    init_fn, step_fn = make_gtcrn_train_step("cpu")
    state = init_fn(params=flat)
    for leaves, loss in (
            (job.state.params, job.loss_fn(*job.batch_tensors(batch))),
            (state.params, step_fn.loss_fn(*job.batch_tensors(batch)))):
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(val_j), rtol=1e-4)
        assert set(leaves) == set(g_j)
        for k, p in leaves.items():
            ref = np.asarray(g_j[k])
            bar = 1e-4 * np.abs(ref).max()
            assert np.abs(p.grad.numpy() - ref).max() <= bar, k
    # AdamW's decay (optax's 1e-4) reaches the BatchNorm statistics
    assert job.state.optimizer.defaults["weight_decay"] == 1e-4
    assert any(k.endswith("running_var") for k in job.state.params)
    state, loss = step_fn(state, *batch)
    assert state.step == 1 and np.isfinite(loss.item())


def _seg_job():
    return trec.segmentation_job(steps=6, batch=2, dur_s=1.0, seed=3,
                                 channels=8, hidden=8, powerset=True, arch="xf",
                                 ds=3, n_xf=1, n_heads=2, device="cpu")


def test_checkpoint_resume(tmp_path):
    job = _seg_job()
    batches = [job.next_batch() for _ in range(3)]
    losses = [job.step(b).item() for b in batches[:2]]
    save_train_state(tmp_path / "state.pt", job.state)
    raw = torch.load(tmp_path / "state.pt", map_location="cpu", weights_only=True)
    assert set(raw) == {"params", "opt_state", "step"} and raw["step"] == 2
    losses.append(job.step(batches[2]).item())
    fresh = _seg_job()
    restore_train_state(tmp_path / "state.pt", fresh.state)
    assert fresh.state.step == 2
    assert fresh.state.scheduler.last_epoch == job.state.scheduler.last_epoch - 1
    assert fresh.step(batches[2]).item() == losses[2]
    for k, p in job.state.params.items():
        assert torch.equal(p, fresh.state.params[k]), k


def test_export_loads_in_both_packages(tmp_path):
    from speech_diarization_tpu.train.recipes import load_segmentation as jload
    from speech_diarization_tpu_torch.models.port import (
        load_params_meta, load_segmentation,
    )

    job = _seg_job()
    job.step()
    path = tmp_path / "seg.npz"
    export_inference_weights(path, job.net, job.meta)
    jmodel, jparams = jload(path)
    tmodel = load_segmentation(path)
    assert load_params_meta(path) == job.meta
    assert set(jrec._flatten(jparams)) == set(jrec._flatten(
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))))
    wave = np.random.default_rng(0).standard_normal((1, 16000)).astype(np.float32)
    ref = np.asarray(jax.jit(jmodel.head_logits)(jparams, jnp.asarray(wave)))
    with torch.no_grad():
        out = tmodel.head_logits(torch.from_numpy(wave)).numpy()
        mine = job.model.head_logits(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(out, mine, rtol=0, atol=0)
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())


def test_refuse_autograd():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.refuse_autograd("fused_log_mel", torch.zeros(3), x)
    with torch.no_grad():
        kernels.refuse_autograd("fused_log_mel", x)
    kernels.refuse_autograd("asp_grid_stats", torch.zeros(3), None)
    kernels.refuse_autograd("asp_grid_stats", x.detach())


def test_the_k1_head_refuses_a_batch_of_chunks():
    """K1 pools one chunk: a batch of chunks on the kernel backend is
    refused before any work, on any device; the plain head takes it."""
    from speech_diarization_tpu_torch.models.ecapa import EcapaModel, EcapaTdnn

    model = EcapaModel(EcapaTdnn(n_mels=40, channels=32, emb_dim=16, scale=4,
                                 se_channels=8, att_channels=8))
    feats = torch.zeros(2, 301, 40)
    with pytest.raises(ValueError, match="one chunk"):
        model.encode_grid_feats(feats, 5, 0, 16000, 4000, backend="kernel")
    out = model.encode_grid_feats(feats, 5, 0, 16000, 4000, backend="decomposed")
    assert out.shape == (2, 5, 16)


def test_constants_made_in_inference_mode_serve_training():
    from speech_diarization_tpu_torch.dsp.stft import istft_ri, stft_ri
    from speech_diarization_tpu_torch.models.layers import sliding_mean_time

    # sizes no other test uses, so this call makes the constants
    with torch.inference_mode():
        istft_ri(stft_ri(torch.zeros(1, 1000), 136, 68), 136, 68)
        sliding_mean_time(torch.zeros(1, 3, 57), 13)
    x = torch.randn(1, 1000, requires_grad=True)
    istft_ri(stft_ri(x, 136, 68), 136, 68).sum().backward()
    y = torch.randn(1, 3, 57, requires_grad=True)
    sliding_mean_time(y, 13).sum().backward()
    assert x.grad is not None and y.grad is not None

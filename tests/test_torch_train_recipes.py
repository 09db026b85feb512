"""Step 1 of the port's recipes against the JAX recipes' loss functions.

Each case starts both packages from the same JAX ``init`` (carried across
as a flat dict of arrays, BatchNorm statistics included), draws batch 1
from the recipe's ``default_rng(seed)`` in both (byte-equal), and compares
the loss (rtol 1e-4) and the gradient of every leaf (within 1e-4 of the
leaf's largest magnitude) with ``jax.value_and_grad`` of the JAX recipe's
loss, written as ``train/recipes.py`` writes it.  Small widths; the VAD at
its shipped width.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu.train.objectives import bce_vad_loss, si_snr_loss
from speech_diarization_tpu_torch.train import recipes as trec

torch.set_num_threads(2)
LOSS_RTOL = 1e-4
GRAD_REL = 1e-4


def compare_step(job, jloss, jparams, batch_j, exact_zero=()):
    """Loss and per-leaf gradients of the port's job on its first batch
    against the JAX loss on the JAX recipe's first batch.  A leaf's bar is
    1e-4 of its largest magnitude, or of 1e-3 of the largest gradient of all
    where the leaf's is smaller (a gradient that nearly cancels).  Leaves in
    ``exact_zero`` have a zero gradient in exact arithmetic, the rounding
    noise of a sum over every output sample: on both sides it must stay
    under 1e-5 of the largest gradient of all."""
    batch_t = job.next_batch()
    for a, b in zip(batch_j, batch_t):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    val_j, g_j = jax.jit(jax.value_and_grad(jloss))(
        jparams, *(jnp.asarray(b) for b in batch_j))
    g_j = jrec._flatten(g_j)
    loss = job.loss_fn(*job.batch_tensors(batch_t))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val_j), rtol=LOSS_RTOL)
    assert set(job.state.params) == set(g_j)
    top = max(float(np.abs(np.asarray(g)).max()) for g in g_j.values())
    for k, p in job.state.params.items():
        ref = np.asarray(g_j[k])
        got = p.grad.numpy()
        if k in exact_zero:
            assert max(np.abs(ref).max(), np.abs(got).max()) <= 1e-5 * top, k
            continue
        bar = GRAD_REL * max(np.abs(ref).max(), 1e-3 * top)
        assert np.abs(got - ref).max() <= bar, (k, np.abs(got - ref).max(), bar)
    return float(val_j)


@pytest.mark.parametrize("arch", ["conv", "gru"])
def test_vad_step(arch):
    from speech_diarization_tpu.models.vad import VadConvNet, VadModel
    from speech_diarization_tpu.train.synthetic import make_vad_example

    model = VadModel(VadConvNet() if arch == "conv" else None)
    params = jax.jit(model.init)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    batch = tuple(np.stack(x) for x in zip(*(make_vad_example(rng, 2.0)
                                             for _ in range(2))))

    def jloss(p, wavs, labels):
        probs = model.probs(p, wavs)
        n = min(probs.shape[-1], labels.shape[-1])
        return bce_vad_loss(probs[..., :n], labels[..., :n])

    job = trec.vad_job(batch=2, dur_s=2.0, seed=0, arch=arch,
                       init_params=jrec._flatten(params), device="cpu")
    compare_step(job, jloss, params, batch)


@pytest.mark.parametrize("arch,powerset,ow", [("xf", True, 2.0),
                                              ("gru", False, 0.0)])
def test_segmentation_step(arch, powerset, ow):
    from speech_diarization_tpu.models.segmentation import (
        SegmentationModel, SegNet, pit_bce_loss, powerset_pit_ce_loss,
    )
    from speech_diarization_tpu.train.synthetic import make_segmentation_example

    kw = dict(channels=16, hidden=16, n_speakers=3, powerset=powerset, n_gru=1,
              n_fc=1, ds=3 if arch == "xf" else 1, arch=arch, n_xf=2, n_heads=2)
    model = SegmentationModel(net=SegNet(**kw))
    params = jax.jit(model.init)(jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    batch = tuple(np.stack(x) for x in zip(*(
        make_segmentation_example(rng, 2.0, max_speakers=3) for _ in range(2))))

    def jloss(p, wavs, labels):
        if powerset:
            logits = model.head_logits(p, wavs)
            n = min(logits.shape[1], labels.shape[1])
            return powerset_pit_ce_loss(logits[:, :n], labels[:, :n],
                                        overlap_weight=ow)
        act = model.activities(p, wavs)
        n = min(act.shape[1], labels.shape[1])
        return pit_bce_loss(act[:, :n], labels[:, :n])

    job = trec.segmentation_job(
        steps=10, batch=2, dur_s=2.0, seed=4, init_params=jrec._flatten(params),
        overlap_weight=ow, device="cpu", max_speakers=3,
        **{k: v for k, v in kw.items() if k != "n_speakers"})
    compare_step(job, jloss, params, batch)
    # the cosine schedule: the first update at the full rate, then decay
    assert job.state.optimizer.param_groups[0]["lr"] == pytest.approx(2e-3)
    job.state.optimizer.step()
    job.state.scheduler.step()
    assert job.state.optimizer.param_groups[0]["lr"] < 2e-3


def test_zipenhancer_step():
    from speech_diarization_tpu.models.zipenhancer import ZipEnhancerModel
    from speech_diarization_tpu_torch.models.zipenhancer import (
        ZipEnhancerModel as TZip,
    )

    model = ZipEnhancerModel(channels=16, blocks=1, heads=2)
    params = jax.jit(model.init)(jax.random.PRNGKey(6))
    batch = jrec.make_noisy_clean_batch(np.random.default_rng(6), 2, 0.5)

    def jloss(p, noisy, clean):
        return si_snr_loss(model.apply(p, noisy), clean)

    job = trec.zipenhancer_job(batch=2, dur_s=0.5, seed=6,
                               net=TZip(channels=16, blocks=1, heads=2),
                               init_params={k: np.asarray(v)
                                            for k, v in params.items()},
                               device="cpu")
    compare_step(job, jloss, params, batch)


def test_demixer_step():
    from speech_diarization_tpu.models.demix import DialogDemixer
    from speech_diarization_tpu.train.synthetic import make_demix_example
    from speech_diarization_tpu_torch.models.demix import DialogDemixer as TDemix

    kw = dict(channels=8, depth=2, bottleneck_blocks=1)
    model = DialogDemixer(**kw)
    params = jax.jit(model.init)(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    batch = tuple(np.stack(x) for x in zip(*(make_demix_example(rng, 0.25, 44100)
                                             for _ in range(2))))

    def jloss(p, mix, stems):
        est = model.apply(p, mix)
        b, s, c, t = est.shape
        return si_snr_loss(est.reshape(b * s * c, t), stems.reshape(b * s * c, t))

    job = trec.demixer_job(batch=2, dur_s=0.25, seed=7, net=TDemix(**kw),
                           init_params={k: np.asarray(v) for k, v in params.items()},
                           device="cpu")
    # the last bias shifts each output by a constant, which SI-SNR removes
    compare_step(job, jloss, params, batch, exact_zero=("dec0_b",))

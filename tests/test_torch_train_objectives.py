"""The port's training objectives and optimizers against the JAX package's.

Bars: every objective (AAM-softmax, SI-SNR, frame BCE, angular
prototypical, PIT-BCE, powerset PIT-CE with and without the overlap weight)
within rtol 1e-5 in value and in its gradient (``jax.grad`` against
autograd, float32, summation order differs); the best-permutation accuracy
equal; Adam, AdamW (decay 1e-4, optax's default) and Adam on the cosine
schedule within atol 1e-6 of optax over 5 steps on the same gradients.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from speech_diarization_tpu.models import segmentation as jseg
from speech_diarization_tpu.train import objectives as jobj
from speech_diarization_tpu.train.proto import angular_proto_loss as j_proto
from speech_diarization_tpu_torch.models import segmentation as tseg
from speech_diarization_tpu_torch.train import objectives as tobj
from speech_diarization_tpu_torch.train import optim
from speech_diarization_tpu_torch.train.proto import angular_proto_loss as t_proto

RTOL = 1e-5


def check(jfn, tfn, arrays, grad_argnums, atol=1e-7):
    """Value and gradients (w.r.t. ``grad_argnums``) of both functions on
    the same float32 arrays."""
    jargs = [jnp.asarray(a) for a in arrays]
    val_j, grads_j = jax.value_and_grad(jfn, argnums=grad_argnums)(*jargs)
    targs = [torch.tensor(a, requires_grad=i in grad_argnums)
             for i, a in enumerate(arrays)]
    val_t = tfn(*targs)
    val_t.backward()
    np.testing.assert_allclose(val_t.item(), float(val_j), rtol=RTOL)
    for i, g in zip(grad_argnums, grads_j):
        np.testing.assert_allclose(targs[i].grad.numpy(), np.asarray(g),
                                   rtol=RTOL, atol=atol)


def test_aam_softmax():
    g = np.random.default_rng(0)
    emb = g.standard_normal((6, 16)).astype(np.float32)
    w = g.standard_normal((5, 16)).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 4, 1])
    check(lambda e, c: jobj.aam_softmax_loss(e, c, jnp.asarray(labels)),
          lambda e, c: tobj.aam_softmax_loss(e, c, torch.as_tensor(labels)),
          [emb, w], (0, 1))


def test_si_snr():
    g = np.random.default_rng(1)
    est = g.standard_normal((3, 400)).astype(np.float32)
    ref = (est + 0.5 * g.standard_normal((3, 400))).astype(np.float32)
    check(jobj.si_snr_loss, tobj.si_snr_loss, [est, ref], (0,))


def test_bce_vad():
    g = np.random.default_rng(2)
    p = g.uniform(0.0, 1.0, (4, 50)).astype(np.float32)
    p[0, :3] = [0.0, 1.0, 0.5]                      # the clip's both ends
    t = (g.uniform(size=(4, 50)) > 0.5).astype(np.float32)
    check(jobj.bce_vad_loss, tobj.bce_vad_loss, [p, t], (0,))


def test_angular_proto():
    g = np.random.default_rng(3)
    emb = g.standard_normal((4, 3, 8)).astype(np.float32)
    check(j_proto, t_proto,
          [emb, np.float32(10.0), np.float32(-5.0)], (0, 1, 2))


@pytest.mark.parametrize("k", [2, 3])
def test_pit_bce(k):
    g = np.random.default_rng(4)
    pred = g.uniform(0.01, 0.99, (3, 20, k)).astype(np.float32)
    tgt = (g.uniform(size=(3, 20, k)) > 0.6).astype(np.float32)
    check(jseg.pit_bce_loss, tseg.pit_bce_loss, [pred, tgt], (0,))


@pytest.mark.parametrize("overlap_weight", [0.0, 2.0])
def test_powerset_pit_ce(overlap_weight):
    g = np.random.default_rng(5)
    logits = g.standard_normal((3, 30, 8)).astype(np.float32)
    tgt = (g.uniform(size=(3, 30, 3)) > 0.5).astype(np.float32)
    check(lambda x, y: jseg.powerset_pit_ce_loss(x, y, overlap_weight),
          lambda x, y: tseg.powerset_pit_ce_loss(x, y, overlap_weight),
          [logits, tgt], (0,))


def test_best_permutation_accuracy():
    g = np.random.default_rng(6)
    pred = (g.uniform(size=(4, 25, 3)) > 0.5).astype(np.float32)
    tgt = (g.uniform(size=(4, 25, 3)) > 0.5).astype(np.float32)
    assert (tseg.best_permutation_accuracy(pred, tgt)
            == jseg.best_permutation_accuracy(pred, tgt))
    assert (tseg.best_permutation_accuracy(pred[0], tgt[0])
            == jseg.best_permutation_accuracy(pred[0], tgt[0]))


def _run_optax(opt, params, grads):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, upd)
    return {k: np.asarray(v) for k, v in p.items()}


def _run_torch(make, params, grads, schedule=None):
    p = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = make(list(p.values()))
    sched = schedule(opt) if schedule else None
    for g in grads:
        for k, v in g.items():
            p[k].grad = torch.tensor(v)
        opt.step()
        if sched:
            sched.step()
    return {k: v.detach().numpy() for k, v in p.items()}


@pytest.mark.parametrize("kind", ["adam", "adamw", "adam_cosine"])
def test_optimizers_match_optax(kind):
    g = np.random.default_rng(7)
    params = {"w": g.standard_normal((4, 3)).astype(np.float32),
              "bias": g.standard_normal(3).astype(np.float32),
              "bn_var": g.uniform(0.5, 2.0, 3).astype(np.float32)}
    # gradients of every size, one leaf with exact zeros
    grads = [{k: (g.standard_normal(v.shape) * 10.0 ** g.uniform(-4, 1)
                  ).astype(np.float32) for k, v in params.items()}
             for _ in range(5)]
    grads[2]["bias"][:] = 0.0
    lr, steps = 1e-2, 5
    if kind == "adam":
        ref = _run_optax(optax.adam(lr), params, grads)
        out = _run_torch(lambda ps: optim.adam(ps, lr), params, grads)
    elif kind == "adamw":
        ref = _run_optax(optax.adamw(lr), params, grads)
        out = _run_torch(lambda ps: optim.adamw(ps, lr), params, grads)
    else:
        ref = _run_optax(optax.adam(optax.cosine_decay_schedule(lr, steps, 0.05)),
                         params, grads)
        out = _run_torch(lambda ps: optim.adam(ps, lr), params, grads,
                         lambda o: optim.cosine_decay(o, steps, 0.05))
    for k in params:
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-6)
        # the update moved every leaf (the decay reaches the BN statistics)
        assert not np.array_equal(out[k], params[k])


def test_adamw_decay_is_optax_default():
    assert torch.optim.AdamW([torch.nn.Parameter(torch.zeros(1))]).defaults[
        "weight_decay"] != 1e-4                       # torch's own default
    opt = optim.adamw([torch.nn.Parameter(torch.zeros(1))], 1e-3)
    assert opt.defaults["weight_decay"] == 1e-4


def test_cosine_schedule_values():
    sched = optax.cosine_decay_schedule(2e-3, 10, 0.05)
    for count in range(12):
        np.testing.assert_allclose(2e-3 * optim.cosine_factor(count, 10, 0.05),
                                   float(sched(count)), rtol=1e-6)

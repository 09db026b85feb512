"""The port's mesh training steps against the JAX package's and against its
own single-device steps, on the CPU.

* ``make_ecapa_train_step`` on a dp 4 x tp 2 mesh of the CPU against the
  JAX step on ``make_mesh(8, tp=2)`` from the same flat params: the losses
  of three steps at rtol 1e-4 (16 rows: train-mode BN over 4 is
  ill-conditioned).  Both take AdamW at lr 1e-4: at the default 1e-3 the
  first update moves every weight by about the rate whatever its gradient's
  size, and the few stem weights whose gradient is 6e-5 of the largest get
  opposite signs in the two packages even on one device, so the third loss
  differs by 1e-2 there (single device against single device as well).
* The port's mesh gradients against its single-device gradients at dp 8,
  dp 4 x tp 2 and dp 2 x tp 2: each leaf within 1e-5 of the gradient's
  largest magnitude.  Per leaf, 1e-7 of noise on the input moves ``mfa``'s
  BN scale by 1.1e-4 of its own largest on one device: that is the step's
  conditioning, and the mesh stays inside it.
* Whole-batch BN statistics: ``batch_stats`` on uneven shards in their
  threads equals it on the whole batch, values and gradients.
* ``make_gtcrn_train_step`` on dp 2 against the JAX step on ``make_mesh(2)``.
* Reproducibility: a mesh step taken twice from one state, the shard
  threads' histories made to differ the second time, gives bitwise-equal
  leaves and optimizer moments (ECAPA dp 4 x tp 2, GTCRN dp 2); the
  broadcast of leaves and the BN exchange against autograd of the
  unsharded computation, and their backward's sums in rank order.
* ``dryrun_multichip(2)`` and ``(8)`` on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from speech_diarization_tpu.models.ecapa import EcapaModel, EcapaTdnn
from speech_diarization_tpu.parallel import make_mesh as jmesh
from speech_diarization_tpu.train import recipes as jrec
from speech_diarization_tpu.train import steps as jsteps
from speech_diarization_tpu_torch.models.ecapa import EcapaTdnn as TEcapa
from speech_diarization_tpu_torch.models.ecapa import batch_stats
from speech_diarization_tpu_torch.parallel import make_mesh
from speech_diarization_tpu_torch.parallel import collective
from speech_diarization_tpu_torch.parallel.collective import run_shards
from speech_diarization_tpu_torch.parallel.sharding import SplitLeaf
from speech_diarization_tpu_torch.train.steps import (
    leaf_list, make_ecapa_train_step, make_gtcrn_train_step,
)

torch.set_num_threads(2)
SMALL = dict(n_mels=40, channels=32, emb_dim=16, scale=4, se_channels=8,
             att_channels=8)
N_CLASSES = 6


def _adamw(ps):
    return torch.optim.AdamW(ps, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


@pytest.fixture(scope="module")
def draw():
    """JAX init of the small ECAPA with a classifier, as a flat dict; 16
    rows of 1 s and their labels."""
    params = jax.jit(EcapaModel(EcapaTdnn(**SMALL)).init)(jax.random.PRNGKey(3))
    params["classifier"] = 0.05 * jax.random.normal(
        jax.random.PRNGKey(103), (N_CLASSES, SMALL["emb_dim"]))
    flat = {k: np.array(v) for k, v in jrec._flatten(params).items()}
    rng = np.random.default_rng(0)
    wavs = rng.standard_normal((16, 16000)).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, 16)
    return flat, wavs, labels


def _replicated_step(state, mesh):
    """The step count as a replicated array: the state then enters the jit
    with the layout it leaves it with, and the second step reuses the first
    one's compile."""
    return jsteps.TrainState(state.params, state.opt_state, jax.device_put(
        jnp.asarray(0), NamedSharding(mesh, PartitionSpec())))


def _jax_tree(flat):
    shapes = jax.eval_shape(EcapaModel(EcapaTdnn(**SMALL)).init, jax.random.PRNGKey(0))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    keys = ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in leaves]
    tree = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(flat[k]) for k in keys])
    return dict(tree, classifier=jnp.asarray(flat["classifier"]))


def test_ecapa_mesh_step_matches_the_jax_mesh_step(draw):
    flat, wavs, labels = draw
    opt = optax.adamw(1e-4)
    mesh = jmesh(8, tp=2)
    _, jstep, jshard = jsteps.make_ecapa_train_step(
        mesh, EcapaTdnn(**SMALL), N_CLASSES, optimizer=opt)
    params = _jax_tree(flat)
    jstate = _replicated_step(jshard(jsteps.TrainState(params, opt.init(params), 0)),
                              mesh)
    init_fn, step_fn, shard_state = make_ecapa_train_step(
        make_mesh(devices=["cpu"] * 8, tp=2), TEcapa(**SMALL), N_CLASSES,
        optimizer=_adamw)
    state = shard_state(init_fn(params=flat))
    split = {k for k, p in state.params.items() if isinstance(p, SplitLeaf)}
    assert {"classifier", "mfa/w", "att_w1", "att_w2", "fc_w"} <= split
    assert all(k.startswith(("mfa", "att_w", "fc_w", "classifier")) for k in split)
    losses = []
    for _ in range(3):
        jstate, jl = jstep(jstate, wavs, labels)
        state, tl = step_fn(state, wavs, labels)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
        losses.append(tl.item())
    assert state.step == 3 and losses[2] < losses[1] < losses[0]   # it trains


@pytest.mark.parametrize("n,tp", [(8, 1), (8, 2), (4, 2)],
                         ids=["dp8", "dp4xtp2", "dp2xtp2"])
def test_mesh_gradients_equal_single_device(draw, n, tp):
    flat, wavs, labels = draw
    grads = []
    for where in ("cpu", make_mesh(devices=["cpu"] * n, tp=tp)):
        init_fn, step_fn, shard_state = make_ecapa_train_step(
            where, TEcapa(**SMALL), N_CLASSES)
        state = shard_state(init_fn(params=flat))
        loss = step_fn.loss_fn(state.params, torch.from_numpy(wavs),
                               torch.from_numpy(labels))
        loss.backward()
        grads.append((loss.item(), {k: p.grad for k, p in state.params.items()}))
    (l1, g1), (l2, g2) = grads
    np.testing.assert_allclose(l2, l1, rtol=1e-6)
    top = max(float(g.abs().max()) for g in g1.values() if g is not None)
    for k, g in g1.items():
        if g is None:    # the running statistics: train-mode BN skips them
            assert g2[k] is None, k
            continue
        assert float((g2[k] - g).abs().max()) <= 1e-5 * top, k


def test_mesh_state_checkpoint_resumes_exactly(draw, tmp_path):
    """``save_train_state`` gathers a split leaf; restoring into a placed
    template splits it again, with the optimizer's moments per piece: the
    resumed step equals the uninterrupted one."""
    from speech_diarization_tpu_torch.train.checkpoint import (
        restore_train_state, save_train_state,
    )

    flat, wavs, labels = draw
    mesh = make_mesh(devices=["cpu"] * 4, tp=2)

    def fresh():
        init_fn, step_fn, shard_state = make_ecapa_train_step(
            mesh, TEcapa(**SMALL), N_CLASSES)
        return shard_state(init_fn(params=flat)), step_fn

    state, step_fn = fresh()
    state, _ = step_fn(state, wavs, labels)
    save_train_state(tmp_path / "mesh.pt", state)
    _, want = step_fn(state, wavs[::-1].copy(), labels[::-1].copy())
    template, step2 = fresh()
    restored = restore_train_state(tmp_path / "mesh.pt", template)
    assert restored.step == 1 and isinstance(restored.params["fc_w"], SplitLeaf)
    _, got = step2(restored, wavs[::-1].copy(), labels[::-1].copy())
    assert got.item() == want.item()
    for k, p in state.params.items():
        torch.testing.assert_close(restored.params[k].detach(), p.detach(),
                                   rtol=0, atol=0)


def test_whole_batch_bn_statistics_under_uneven_shards():
    x = torch.randn(16, 12, 50, dtype=torch.float64).float().requires_grad_(True)
    sizes = [5, 7, 4]
    blocks = x.split(sizes)
    mean, var = batch_stats(x, (0, 2))
    # the whole batch's statistics in every shard, weighted into one output
    out = run_shards([torch.device("cpu")] * 3,
                     lambda r: batch_stats(blocks[r], (0, 2)))
    for m, v in out:
        torch.testing.assert_close(m, mean, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(v, var, rtol=1e-6, atol=1e-6)
    w = torch.randn(12)
    (g_whole,) = torch.autograd.grad((mean * w).sum() + (var * w).sum(), x)
    shard_sum = sum(((m * w).sum() + (v * w).sum()) * n / 16
                    for (m, v), n in zip(out, sizes))
    (g_shard,) = torch.autograd.grad(shard_sum, x)
    torch.testing.assert_close(g_shard, g_whole, rtol=1e-5, atol=1e-7)
    # outside a shard: the call's own rows
    torch.testing.assert_close(batch_stats(blocks[0], (0, 2))[0],
                               blocks[0].mean((0, 2)))


def test_a_shard_that_fails_releases_the_others():
    def fn(r):
        if r == 1:
            raise ValueError("shard 1")
        return batch_stats(torch.ones(2, 3, 4), (0, 2))

    with pytest.raises(ValueError, match="shard 1"):
        run_shards([torch.device("cpu")] * 4, fn)


def test_shard_turns_under_stress():
    """More shards than cores, 200 meetings each, a switch interval of
    1 us: every meeting sees every shard's part of that meeting, and the
    long-lived threads serve a second run and end when closed."""
    import sys
    import threading

    from speech_diarization_tpu_torch.parallel.collective import (
        ShardWorkers, current_group,
    )

    n = 16
    workers = ShardWorkers([torch.device("cpu")] * n)

    def fn(r):
        group, rank = current_group()
        return [group.exchange(rank, (i, rank), lambda parts: [p for p in parts])
                for i in range(200)]

    results = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        runner = threading.Thread(target=lambda: results.extend(
            [workers.run(fn), workers.run(fn)]))
        runner.start()
        runner.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        workers.close()
    assert not runner.is_alive() and len(results) == 2
    for out in results:
        for r in range(n):
            assert all(seen == [(i, q) for q in range(n)]
                       for i, seen in enumerate(out[r]))


def test_gtcrn_mesh_step_matches_jax():
    """From the port's seeded init (``train/init.py``: the JAX inits'
    distributions; a JAX init would cost the file another compile)."""
    from speech_diarization_tpu_torch.models.gtcrn import GTCRN
    from speech_diarization_tpu_torch.models.port import flat_params
    from speech_diarization_tpu_torch.train.init import init_like_jax

    flat = flat_params(init_like_jax(GTCRN(), 2))
    params = {k: jnp.asarray(v) for k, v in flat.items()}
    noisy, clean = jrec.make_noisy_clean_batch(np.random.default_rng(5), 2, 1.0)
    opt = optax.adamw(1e-4)
    mesh = jmesh(2)
    _, jstep = jsteps.make_gtcrn_train_step(mesh, optimizer=opt)
    jstate = jax.device_put(jsteps.TrainState(params, opt.init(params), jnp.asarray(0)),
                            NamedSharding(mesh, PartitionSpec()))
    init_fn, step_fn = make_gtcrn_train_step(make_mesh(devices=["cpu"] * 2),
                                             optimizer=_adamw)
    state = init_fn(params=flat)
    for _ in range(2):
        jstate, jl = jstep(jstate, noisy, clean)
        state, tl = step_fn(state, noisy, clean)
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)


def _autograd_nodes(n: int) -> None:
    """``n`` autograd nodes made on the calling thread: its count of nodes,
    which orders autograd's ready queue, moves ahead of other threads'."""
    x = torch.ones(1, requires_grad=True)
    for _ in range(n):
        x = x * 1.0


def _assert_same_state(a, b) -> None:
    """Every leaf and every optimizer moment bitwise equal."""
    for pa, pb in zip(leaf_list(a.params), leaf_list(b.params), strict=True):
        assert torch.equal(pa, pb)
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        assert sa.keys() == sb.keys()
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key


@pytest.mark.parametrize("how", ["history", "reassigned"])
def test_ecapa_mesh_step_is_reproducible_across_thread_histories(draw, how):
    """dp 4 x tp 2: step 2 taken twice from one state; the second time rank
    1's thread has run extra autograd work first, or the ranks run on one
    another's threads.  Every cross-shard gradient sum is made in rank
    order, so nothing may differ."""
    flat, wavs, labels = draw
    mesh = make_mesh(devices=["cpu"] * 8, tp=2)
    runs = []
    for perturb in (False, True):
        init_fn, step_fn, shard_state = make_ecapa_train_step(
            mesh, TEcapa(**SMALL), N_CLASSES)
        state = shard_state(init_fn(params=flat))
        state, _ = step_fn(state, wavs, labels)
        workers = step_fn.replicas.workers
        if perturb and how == "history":
            workers.run(lambda r: _autograd_nodes(997) if r == 1 else None)
        elif perturb:
            workers.reassign([3, 2, 1, 0])
        state, loss = step_fn(state, wavs[::-1].copy(), labels[::-1].copy())
        runs.append((state, loss.item()))
    (a, loss_a), (b, loss_b) = runs
    assert loss_a == loss_b
    _assert_same_state(a, b)


def test_gtcrn_mesh_step_is_reproducible_across_thread_histories():
    """dp 2: the shards run in turn on the calling thread through the
    broadcast leaves; step 2 after extra autograd work on that thread
    equals step 2 without."""
    from speech_diarization_tpu_torch.models.gtcrn import GTCRN
    from speech_diarization_tpu_torch.models.port import flat_params
    from speech_diarization_tpu_torch.train.init import init_like_jax

    flat = flat_params(init_like_jax(GTCRN(), 2))
    noisy, clean = jrec.make_noisy_clean_batch(np.random.default_rng(5), 2, 1.0)
    runs = []
    for perturb in (False, True):
        init_fn, step_fn = make_gtcrn_train_step(make_mesh(devices=["cpu"] * 2))
        state = init_fn(params=flat)
        state, _ = step_fn(state, noisy, clean)
        if perturb:
            _autograd_nodes(997)
        state, loss = step_fn(state, clean, noisy)
        runs.append((state, loss.item()))
    (a, loss_a), (b, loss_b) = runs
    assert loss_a == loss_b
    _assert_same_state(a, b)


def test_broadcast_gradient_is_the_rank_ordered_sum():
    """Copies and gradients against autograd of the leaves used by every
    rank (float64; a leaf no rank reaches keeps no gradient); then a
    float32 leaf's gradient is the rank-ordered sum of constructed ones."""
    cpu = [torch.device("cpu")] * 3
    ts = [torch.randn(5, 7, dtype=torch.float64).requires_grad_(True),
          torch.randn(3, dtype=torch.float64).requires_grad_(True),
          torch.randn(2, dtype=torch.float64).requires_grad_(True)]
    copies = collective.broadcast(ts, cpu)
    assert len({c.data_ptr() for rank in copies for c in rank}) == 9
    for rank in copies:
        for c, t in zip(rank, ts, strict=True):
            assert torch.equal(c, t)
    w = [[torch.randn(t.shape, dtype=torch.float64) for t in ts[:2]] for _ in cpu]
    g = torch.autograd.grad(
        sum((c * wc).sum() for rank, wr in zip(copies, w) for c, wc in zip(rank, wr)),
        ts, allow_unused=True)
    g_whole = torch.autograd.grad(
        sum((t * wc).sum() for wr in w for t, wc in zip(ts, wr)), ts[:2])
    for got, want in zip(g, g_whole, strict=False):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    assert g[2] is None
    # 1 + 2^-24 rounds back to 1 in float32; 2^-24 + 2^-24 does not
    tiny = 2.0 ** -24
    grads = [torch.full((5, 7), v) for v in (1.0, tiny, tiny)]
    t = ts[0].detach().float().requires_grad_(True)
    copies = collective.broadcast([t], cpu)
    (g,) = torch.autograd.grad([rank[0] for rank in copies], t, grad_outputs=grads)
    assert torch.equal(g, (grads[0] + grads[1]) + grads[2])
    assert not torch.equal(g, (grads[2] + grads[1]) + grads[0])


def test_bn_exchange_matches_the_whole_batch_and_sums_in_rank_order():
    """The exchange's statistics and gradients against autograd of the
    whole batch's (float64, an empty shard among them); then its backward
    with constructed output gradients: each part's gradient is formed from
    the rank-ordered sums."""
    x = torch.randn(16, 12, 50, dtype=torch.float64).requires_grad_(True)
    sizes = [5, 0, 7, 4]
    blocks = x.split(sizes)

    def shard(r):
        group, rank = collective.current_group()
        return group.mean_var(rank, blocks[r], (0, 2))

    out = run_shards([torch.device("cpu")] * len(sizes), shard)
    mean, var = x.mean((0, 2)), x.var((0, 2), correction=0)
    for m, v in out:
        torch.testing.assert_close(m, mean, rtol=1e-6, atol=0)
        torch.testing.assert_close(v, var, rtol=1e-6, atol=0)
    w = torch.randn(2, 12, dtype=torch.float64)
    (g_whole,) = torch.autograd.grad((mean * w[0]).sum() + (var * w[1]).sum(), x)
    shard_sum = sum(((m * w[0]).sum() + (v * w[1]).sum()) * n / 16
                    for (m, v), n in zip(out, sizes))
    (g_shard,) = torch.autograd.grad(shard_sum, x)
    torch.testing.assert_close(g_shard, g_whole, rtol=1e-6, atol=1e-12)

    counts = [2, 4, 2]             # 8 rows: dividing by them is exact
    cpu = [torch.device("cpu")] * 3
    mus = [torch.randn(1, 3, 1).requires_grad_(True) for _ in counts]
    m2s = [torch.rand(1, 3, 1).requires_grad_(True) for _ in counts]
    stats = collective._MergeStats.apply(counts, cpu, *mus, *m2s)
    tiny = 2.0 ** -24
    g_var = [torch.full((1, 3, 1), v) for v in (1.0, tiny, tiny)]
    grads = [g for gv in g_var for g in (torch.zeros(1, 3, 1), gv)]
    g_m2 = torch.autograd.grad(stats, m2s, grad_outputs=grads)
    for g in g_m2:
        assert torch.equal(g, ((g_var[0] + g_var[1]) + g_var[2]) / 8)
        assert not torch.equal(g, ((g_var[2] + g_var[1]) + g_var[0]) / 8)


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_the_cpu(n):
    from speech_diarization_tpu_torch.dryrun import dryrun_multichip

    out = dryrun_multichip(n, device="cpu")
    assert out["dp"] == n and out["segments"] > 0
    assert out["train_mesh"] == ((n // 2, 2) if n >= 4 else (n, 1))
    assert np.isfinite(out["loss"]) and np.isfinite(out["der_pct"])


def test_entry_on_the_cpu():
    from speech_diarization_tpu_torch.dryrun import entry

    fn, args = entry(device="cpu")
    out = fn(*args)
    assert tuple(out.shape) == (8, 192) and torch.isfinite(out).all()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()

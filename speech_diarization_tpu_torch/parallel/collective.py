"""What one process needs to drive the shards of a mesh step together.

The JAX package jits a step over a mesh and XLA inserts the collectives,
reducing over the shards in a fixed order.  Here one process issues every
shard: a shard that needs no other shard's data (a window batch, a GTCRN
step) is run in turn; a shard whose forward meets the whole batch
(train-mode BatchNorm: the statistics of every row) runs in a thread of its
own, and the threads meet at each reduction.

Every sum across shards is made here, in rank order, so a step's result
does not depend on which thread ran which shard nor on the order in which
autograd reaches the shards' gradients (its ready queue orders nodes by a
count each thread keeps for itself):

* :func:`broadcast`: one copy of each leaf a rank, whose gradients come
  back as one sum a leaf in rank order.
* :meth:`ShardGroup.mean_var`: a reduction over all the shards, combined
  on the first device by one autograd node that also sums its gradients
  in rank order.
* :func:`on_device` makes a CUDA device current for a block (a no-op on
  the CPU): a kernel's C entry launches on the current device.
* :class:`ShardGroup`, :class:`ShardWorkers` / :func:`run_shards`: the dp
  shards of one step, rank ``r`` always on thread ``r``, taking turns.
* :func:`current_group`: the group of the calling thread, or None outside a
  step (``models/ecapa.py::batch_stats`` reads it).
* :func:`bind`: a module's leaves replaced by given tensors for a block, so
  a replica computes with its rank's copies of one set of leaves.
"""
from __future__ import annotations

import contextlib
import math
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import torch

_LOCAL = threading.local()


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device, else a no-op."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def current_group() -> tuple[ShardGroup, int] | None:
    """(group, rank) of the calling thread's shard, or None."""
    return getattr(_LOCAL, "shard", None)


def rank_sum(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``parts[0] + parts[1] + ...`` on ``device``, left to right, in float32
    at least."""
    dtype = torch.promote_types(parts[0].dtype, torch.float32)
    total = parts[0].to(device, dtype)
    for part in parts[1:]:
        total = total + part.to(device, dtype)
    return total


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, *tensors):
        ctx.set_materialize_grads(False)
        ctx.homes = [(t.device, t.dtype, t.shape) for t in tensors]
        out = []
        for d in devices:
            copies = [torch.empty_like(t, device=d) for t in tensors]
            torch._foreach_copy_(copies, tensors)
            out.extend(copies)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.homes)
        reached = [i for i in range(n) if any(g is not None for g in grads[i::n])]
        wide = {i: (ctx.homes[i][0], torch.promote_types(ctx.homes[i][1], torch.float32))
                for i in reached}

        def of_rank(r: int) -> list[torch.Tensor]:
            got = [grads[r * n + i] for i in reached]
            return [torch.zeros(ctx.homes[i][2], device=wide[i][0], dtype=wide[i][1])
                    if g is None else g.to(*wide[i]) for i, g in zip(reached, got)]

        # one add a rank over every reached tensor (``_foreach_add`` adds as
        # ``+`` does), from rank 0 up
        total = of_rank(0)
        for r in range(1, len(grads) // n):
            total = torch._foreach_add(total, of_rank(r))
        sums: list = [None] * n
        for i, t in zip(reached, total):
            sums[i] = t.to(ctx.homes[i][1])
        return (None, *sums)


def broadcast(tensors: Sequence[torch.Tensor],
              devices: Sequence[torch.device]) -> list[list[torch.Tensor]]:
    """A distinct copy of each of ``tensors`` on each of ``devices``, by
    rank, made on the calling thread in one autograd node.  In backward the
    ranks' gradients of each tensor are moved to its device and summed from
    rank 0 up, in float32 at least: one gradient a tensor, whatever order
    autograd reached the copies in (None where no copy was reached)."""
    tensors = list(tensors)
    flat = _Broadcast.apply(list(devices), *tensors)
    n = len(tensors)
    return [list(flat[r:r + n]) for r in range(0, len(flat), n)]


class _MergeStats(torch.autograd.Function):
    """Every rank's (count, mean, sum of squared deviations) merged on the
    first device (Chan's pairwise form: no difference of large sums) into
    the whole batch's mean and biased variance, a copy of each on every
    rank's device.  Autograd runs the node once every rank's output
    gradients are in: they are summed in rank order and each part's
    gradient is formed from the sums."""

    @staticmethod
    def forward(ctx, counts, devices, *parts):
        n = len(counts)
        first = devices[0]
        live = [r for r in range(n) if counts[r]]
        mus = [parts[r].to(first) for r in live]
        ks = [counts[r] for r in live]
        n_all = sum(ks)
        mean = sum(k * mu for k, mu in zip(ks, mus)) / n_all
        m2 = sum(parts[n + r].to(first) + k * (mu - mean) ** 2
                 for r, k, mu in zip(live, ks, mus))
        var = m2 / n_all
        ctx.counts, ctx.live, ctx.first = counts, live, first
        ctx.part_devices = [p.device for p in parts[:n]]
        ctx.save_for_backward(mean, *mus)
        return tuple(x.to(d, copy=True) for d in devices for x in (mean, var))

    @staticmethod
    def backward(ctx, *grads):
        mean, *mus = ctx.saved_tensors
        n = len(ctx.counts)
        g_mean = rank_sum(grads[0::2], ctx.first)
        g_var = rank_sum(grads[1::2], ctx.first)
        n_all = sum(ctx.counts)
        # d var / d mu_r = 2 k_r / N ((mu_r - mean) - s / N), s the weighted
        # deviations' sum (zero in exact arithmetic); d mean / d mu_r = k_r / N
        s = rank_sum([ctx.counts[r] * (mu - mean) for r, mu in zip(ctx.live, mus)],
                     ctx.first)
        g_parts: list = [None] * (2 * n)
        for r, mu in zip(ctx.live, mus):
            dev, k = ctx.part_devices[r], ctx.counts[r]
            g_parts[r] = (k / n_all * (g_mean + 2 * g_var * ((mu - mean) - s / n_all))
                          ).to(dev)
            g_parts[n + r] = (g_var / n_all).to(dev)
        return (None, None, *g_parts)


class BrokenShards(RuntimeError):
    """Another shard of the step raised; this one stopped at a meeting."""


class ShardGroup:
    """The dp shards of one step, one thread each, ``devices[r]`` being
    shard ``r``'s.  The threads take turns, one running at a time: shard 0
    runs until the first reduction, hands the turn to shard 1, and so on;
    the last shard to arrive combines every shard's part in rank order on
    ``devices[0]`` and hands the turn back to shard 0.  Two threads issuing
    small operations at once would hand the GIL back and forth at every
    operation; taking turns hands it over once a reduction."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._parts: list = [None] * len(self.devices)
        self._result = None
        self._turn = 0
        self._broken = False
        self._cond = threading.Condition()

    def _wait_turn(self, rank: int) -> None:
        while self._turn != rank and not self._broken:
            self._cond.wait()
        if self._broken:
            raise BrokenShards("another shard of the step raised")

    def _hand_over(self, rank: int) -> None:
        self._turn = rank
        self._cond.notify_all()

    def begin(self, rank: int) -> None:
        with self._cond:
            self._wait_turn(rank)

    def end(self, rank: int) -> None:
        with self._cond:
            self._hand_over(rank + 1)

    def exchange(self, rank: int, part, combine: Callable):
        """Post ``part``; returns ``combine(parts of every rank)``.  The
        last rank computes it before shard 0 goes on, and reads it on its
        own turn, before it can post again."""
        with self._cond:
            self._parts[rank] = part
            if rank == len(self.devices) - 1:
                self._result = combine(self._parts)
                self._hand_over(0)
            else:
                self._hand_over(rank + 1)
            self._wait_turn(rank)
            return self._result

    def abort(self) -> None:
        with self._cond:
            self._broken = True
            self._cond.notify_all()

    def mean_var(self, rank: int, x32: torch.Tensor, dims):
        """Float32 mean and biased variance over ``dims`` of the whole
        batch, of which ``x32`` is this shard's rows, in one exchange: each
        shard posts its count, mean and sum of squared deviations about its
        mean; the last merges them on the first device in one autograd node
        (:class:`_MergeStats`) whose outputs are a copy for each shard."""
        dims = (dims,) if isinstance(dims, int) else tuple(dims)
        n = math.prod(x32.shape[d] for d in dims)
        mean_i = x32.mean(dims, keepdim=True)
        part = (n, mean_i, ((x32 - mean_i) ** 2).sum(dims, keepdim=True))

        def merge(parts):
            counts = [k for k, _, _ in parts]
            return _MergeStats.apply(counts, self.devices,
                                     *(mu for _, mu, _ in parts),
                                     *(m2 for _, _, m2 in parts))

        stats = self.exchange(rank, part, merge)
        mean, var = stats[2 * rank], stats[2 * rank + 1]
        return mean.squeeze(dims), var.squeeze(dims)


class ShardWorkers:
    """Threads for the dp shards, kept between steps, rank ``r`` always on
    thread ``r`` (an executor of one thread a rank): the per-thread state
    a CUDA library makes on a thread's first call is made once and stays
    with one rank, and a thread's history follows the steps, not a
    scheduler.  The executors join their threads before the interpreter
    exits."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._threads = [ThreadPoolExecutor(1, thread_name_prefix="shard")
                         for _ in self.devices]

    def reassign(self, order: Sequence[int]) -> None:
        """From now on rank ``r`` runs on the thread that ran rank
        ``order[r]`` (a step's result must not change)."""
        if sorted(order) != list(range(len(self._threads))):
            raise ValueError(f"{list(order)} is not an order of "
                             f"{len(self._threads)} ranks")
        self._threads = [self._threads[i] for i in order]

    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(rank)`` for each shard on its thread, with its device
        current, its :class:`ShardGroup` visible to :func:`current_group`,
        and the caller's grad mode.  Returns the results by rank; a shard's
        exception is raised here after every shard has stopped (the others
        are released from their reduction)."""
        group = ShardGroup(self.devices)
        grad = torch.is_grad_enabled()
        out: list = [None] * len(self.devices)
        errors: list = [None] * len(self.devices)

        def body(rank: int) -> None:
            _LOCAL.shard = (group, rank)
            try:
                group.begin(rank)
                with torch.set_grad_enabled(grad), on_device(self.devices[rank]):
                    out[rank] = fn(rank)
                group.end(rank)
            except BaseException as e:  # noqa: BLE001 - raised by the caller
                errors[rank] = e
                group.abort()
            finally:
                _LOCAL.shard = None

        for fut in [t.submit(body, r) for r, t in enumerate(self._threads)]:
            fut.result()
        raised = [e for e in errors if e is not None]
        if raised:    # the shard's own error, not one its abort released
            raise next((e for e in raised if not isinstance(e, BrokenShards)),
                       raised[0])
        return out

    def close(self, wait: bool = True) -> None:
        for t in self._threads:
            t.shutdown(wait=wait)


def run_shards(devices: Sequence[torch.device], fn: Callable[[int], object],
               workers: ShardWorkers | None = None) -> list:
    """:meth:`ShardWorkers.run` on ``workers``, or on threads made for this
    call; one shard runs inline, with no group."""
    devices = list(devices)
    if len(devices) == 1:
        with on_device(devices[0]):
            return [fn(0)]
    if workers is not None:
        return workers.run(fn)
    workers = ShardWorkers(devices)
    try:
        return workers.run(fn)
    finally:
        workers.close()


@contextlib.contextmanager
def bind(module: torch.nn.Module, tensors: dict[str, torch.Tensor]):
    """Within the block, ``module``'s parameter or buffer of each
    ``state_dict`` key in ``tensors`` is that tensor (a rank's copy of a
    leaf from :func:`broadcast`); the module's own entries are put back
    afterwards.  The module must not be used by another thread meanwhile:
    each replica has its own."""
    saved = []
    try:
        for key, t in tensors.items():
            owner, _, name = key.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            table = mod._parameters if name in mod._parameters else mod._buffers
            if name not in table:
                raise KeyError(f"{key}: no such parameter or buffer")
            saved.append((table, name, table[name]))
            table[name] = t
        yield module
    finally:
        for table, name, old in reversed(saved):
            table[name] = old

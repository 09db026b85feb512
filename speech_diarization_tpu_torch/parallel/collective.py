"""What one process needs to drive the shards of a mesh step together.

The JAX package jits a step over a mesh and XLA inserts the collectives.
Here one process issues every shard: a shard that needs no other shard's
data (a window batch, a GTCRN step) is run in turn; a shard whose forward
meets the whole batch (train-mode BatchNorm: the statistics of every row)
runs in a thread of its own, and the threads meet at each reduction.

* :func:`on_device` makes a CUDA device current for a block (a no-op on
  the CPU): a kernel's C entry launches on the current device.
* :class:`ShardGroup`, :class:`ShardWorkers` / :func:`run_shards`: the dp
  shards of one step, each on its thread, taking turns; :meth:`ShardGroup.mean_var` is a
  reduction over all of them, combined on the first device and sent back
  with ``Tensor.to``, which autograd differentiates.
* :func:`current_group`: the group of the calling thread, or None outside a
  step (``models/ecapa.py::batch_stats`` reads it).
* :func:`bind`: a module's leaves replaced by given tensors for a block, so
  a replica computes with copies of one set of leaves and the gradients
  reach those leaves.
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
        mean; the first device merges them (Chan's pairwise form: no
        difference of large sums) and each shard gets the result back."""
        dims = (dims,) if isinstance(dims, int) else tuple(dims)
        n = math.prod(x32.shape[d] for d in dims)
        mean_i = x32.mean(dims, keepdim=True)
        part = (n, mean_i, ((x32 - mean_i) ** 2).sum(dims, keepdim=True))
        first = self.devices[0]

        def merge(parts):
            parts = [(k, mu.to(first), m2) for k, mu, m2 in parts if k]
            n_all = sum(k for k, _, _ in parts)
            mean = sum(k * mu for k, mu, _ in parts) / n_all
            m2 = sum(m2.to(first) + k * (mu - mean) ** 2 for k, mu, m2 in parts)
            return mean, m2 / n_all

        mean, var = self.exchange(rank, part, merge)
        dev = self.devices[rank]
        return mean.to(dev).squeeze(dims), var.to(dev).squeeze(dims)


class ShardWorkers:
    """Threads for the dp shards, kept between steps: a mesh step reuses
    them, so the per-thread state a CUDA library makes on a thread's first
    call is made once, not every step.  A thread pool of one thread a
    shard: each run's shards all wait on one another, so each takes its
    own thread, whichever is free; the pool joins its threads before the
    interpreter exits."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = list(devices)
        self._pool = ThreadPoolExecutor(len(self.devices),
                                        thread_name_prefix="shard")

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

        for fut in [self._pool.submit(body, r) for r in range(len(self.devices))]:
            fut.result()
        raised = [e for e in errors if e is not None]
        if raised:    # the shard's own error, not one its abort released
            raise next((e for e in raised if not isinstance(e, BrokenShards)),
                       raised[0])
        return out

    def close(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)


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
    ``state_dict`` key in ``tensors`` is that tensor (a copy of a leaf
    that lives elsewhere, or the gathered pieces of a split one); the
    module's own entries are put back afterwards.  The module must not be
    used by another thread meanwhile: each replica has its own."""
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

"""Data-parallel training over a mesh: the global batch split into shards.

Port of what the JAX package's ``Trainer(cfg, mesh=)`` gets from XLA: its
jitted step is the one-device program over the global batch with the batch
sharded over the mesh's data axis, so the BatchNorms' batch statistics and
the loss span every shard and the gradient is the global batch's. Here each
shard runs its own slice through the net on its own device, and the pieces
that cross shards are written out:

  * **BatchNorm.** Every shard's forward runs on a thread of its own
    (``ShardThreads``, persistent, so cuDNN's per-thread plans stay warm),
    under ``models/layers.shard_batch_norm``. A training-mode BatchNorm
    computes its shard's (count, mean, M2): M2 about the shard's own mean
    in f32 (a two-pass-quality reduction), the mean reduced in f64, since
    Chan's rule below takes differences of the shards' means: rounded to
    f32 those lose digits of the variance of a channel whose mean is large
    against its spread, where native BatchNorm keeps them. It meets
    the other local shards at a barrier (``_Rendezvous``). The last to
    arrive combines them with Chan's pairwise rule in f64 on the home
    device, then across processes (one all-reduce of every process's
    (mean, M2) in its rank's slot,
    ``parallel/mesh.gather_processes_differentiable``), and updates each
    local replica's running statistics once, in Flax's order of
    operations. Each shard normalizes with the global mean and variance
    in f32 and returns its input's dtype.
  * **The gradient.** The combination is made of differentiable ops on the
    shards' partial statistics, so one ``backward`` from the loss carries
    the cross-shard terms; no barrier sits in the backward (autograd runs
    all of one device's backward work on one thread, so shards sharing a
    device would deadlock there). Across processes the all-reduce's
    backward all-reduces the incoming gradient. Those backward collectives
    come in a fixed order on every process: BatchNorm k's statistics feed
    BatchNorm k + 1's input, so its backward can run only after k + 1's.
  * **The loss.** The embeddings of the local shards go to the home device
    still attached to the graph; the other processes' come detached
    (``all_gather_processes``), so each process back-propagates the global
    loss through its own rows.
  * **The update.** Shards on one device share its replica, whose
    parameters accumulate their gradients; ``reduce_gradients`` sums over
    the local devices' replicas and then over processes in one bucketed
    all-reduce (a sum, not DDP's mean: the loss already averages over the
    global batch) and gives every replica the sum, so the same SGD step
    keeps them bit-equal.

Why threads rather than one forward over the concatenated local shards: a
mesh of four shards on one card must run the code that four cards run
(the statistics combined across shards, the loss gathered, the gradients
summed), and a shard's BatchNorm cannot finish before every shard has
reached it. Threads are how a forward waits at a layer without rewriting
the net; ``torch.nn.parallel.parallel_apply`` runs replicas the same way.
Per thread: ``torch.autocast``, the grad mode and the current CUDA device
(set in each worker); the TF32 flags are global.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Callable, List, Sequence

import torch
import torch.nn as nn

from image_search_engine_tpu_torch.models.layers import at_least_f32
from image_search_engine_tpu_torch.parallel.mesh import (
    TIMEOUT_S, Mesh, all_gather_processes, all_reduce_processes,
    gather_processes_differentiable)


def _merge(a: tuple, b: tuple) -> tuple:
    """Chan's rule: the (count, mean, M2) of two partitions' union."""
    na, ma, sa = a
    nb, mb, sb = b
    n = na + nb
    delta = mb - ma
    return n, ma + delta * (nb / n), sa + sb + delta.square() * (na * nb / n)


def combine_stats(parts: Sequence[tuple]) -> tuple:
    """(count, mean, M2) of the union of ``parts``, merged pairwise in a
    tree in their order."""
    parts = list(parts)
    while len(parts) > 1:
        merged = [_merge(parts[i], parts[i + 1]) for i in range(0, len(parts) - 1, 2)]
        parts = merged + parts[len(parts) - len(parts) % 2:]
    return parts[0]


class _Rendezvous:
    """One step's meeting point of the local shards' BatchNorms: each call
    of ``exchange`` is one layer, the k-th call of every shard the same
    layer."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._slots: list = [None] * mesh.local_size
        self._result = None
        self._barrier = threading.Barrier(mesh.local_size, action=self._combine,
                                          timeout=TIMEOUT_S)

    def abort(self) -> None:
        self._barrier.abort()

    def exchange(self, shard: int, bn: nn.Module, count: int, mean: torch.Tensor,
                 m2: torch.Tensor) -> tuple:
        """Post this shard's f64 statistics; returns the global (mean,
        biased variance) in f64 on the home device."""
        self._slots[shard] = (bn, count, mean, m2)
        self._barrier.wait()
        return self._result

    def _combine(self) -> None:
        mesh, home = self.mesh, self.mesh.home
        n, mean, m2 = combine_stats([(c, mu.to(home), s.to(home)) for _, c, mu, s in self._slots])
        if mesh.group is not None:
            every = gather_processes_differentiable(torch.stack([mean, m2]), mesh)
            n, mean, m2 = combine_stats([(n, every[r, 0], every[r, 1])
                                         for r in range(mesh.world)])
        var = m2 / n
        with torch.no_grad():  # once a step for each local replica
            for bn in {id(b): b for b, *_ in self._slots}.values():
                dev, keep = bn.running_mean.device, 1.0 - bn.momentum
                dt = bn.running_mean.dtype
                bn.running_mean.mul_(keep).add_(mean.detach().to(dev, dt) * bn.momentum)
                bn.running_var.mul_(keep).add_(var.detach().to(dev, dt) * bn.momentum)
                bn.num_batches_tracked.add_(1)
        self._result = (mean, var)


class ShardBatchNorm:
    """One shard's side of the step: what its training-mode BatchNorms call
    (``models/layers.shard_batch_norm``)."""

    def __init__(self, rendezvous: _Rendezvous, shard: int):
        self.rendezvous = rendezvous
        self.shard = shard

    def batch_norm(self, bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
        dims = (0, *range(2, x.dim()))
        xf = at_least_f32(x)
        var_s = torch.var(xf, dim=dims, correction=0)
        mean_s = torch.mean(xf, dim=dims, dtype=torch.float64)
        count = x.numel() // x.shape[1]
        mean, var = self.rendezvous.exchange(self.shard, bn, count, mean_s,
                                             var_s.double() * count)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = torch.rsqrt(var.to(x.device, xf.dtype) + bn.eps) * bn.weight
        out = ((xf - mean.to(x.device, xf.dtype).view(shape)) * scale.view(shape)
               + bn.bias.view(shape))
        return out.to(x.dtype)


class ShardThreads:
    """One persistent daemon thread a local shard; ``run`` calls
    ``fn(shard)`` on every shard's thread and returns the results in shard
    order."""

    def __init__(self, n: int):
        self._queues: List[queue.Queue] = [queue.Queue() for _ in range(n)]
        for s, q in enumerate(self._queues):
            threading.Thread(target=self._loop, args=(q,), daemon=True,
                             name=f"train-shard-{s}").start()

    @staticmethod
    def _loop(q: queue.Queue) -> None:
        while True:
            item = q.get()
            if item is None:
                return
            fn, fut = item
            try:
                fut.set_result(fn())
            except BaseException as e:  # handed to the caller
                fut.set_exception(e)
            # hold nothing of the step while waiting: the task's closure
            # reaches the trainer, which would then never be collected
            item = fn = fut = None

    def run(self, fn: Callable[[int], object], on_error: Callable[[], None]) -> list:
        """``on_error`` runs as soon as a shard fails (to release the others
        from a barrier); the first failure that is not a broken barrier is
        raised."""
        def guarded(s):
            try:
                return fn(s)
            except BaseException:
                on_error()
                raise

        futs = [cf.Future() for _ in self._queues]
        for s, (q, fut) in enumerate(zip(self._queues, futs)):
            q.put((lambda s=s: guarded(s), fut))
        cf.wait(futs)
        errors = [f.exception() for f in futs if f.exception() is not None]
        if errors:
            raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                       errors[0])
        return [f.result() for f in futs]

    def close(self) -> None:
        for q in self._queues:
            q.put(None)


def run_shards(fn: Callable[[int, ShardBatchNorm], object], mesh: Mesh,
               threads: ShardThreads | None) -> list:
    """``fn(shard, sync)`` for every local shard, each on its thread, with
    one rendezvous for the step (inline when the process has one shard)."""
    rendezvous = _Rendezvous(mesh)
    if threads is None:
        return [fn(0, ShardBatchNorm(rendezvous, 0))]
    return threads.run(lambda s: fn(s, ShardBatchNorm(rendezvous, s)), rendezvous.abort)


def gather_batch(local: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """Every process's rows of ``local`` (along ``dim``) concatenated in
    rank order on its device: this process's attached to the graph, the
    others' detached."""
    if mesh.group is None:
        return local
    parts = all_gather_processes(local.detach(), mesh)
    parts[mesh.rank] = local
    return torch.cat(parts, dim=dim)


def reduce_gradients(replicas: Sequence[nn.Module], mesh: Mesh) -> None:
    """Sum each parameter's gradient over the local replicas (in their
    order, on the first's device) and over every process (one all-reduce
    of all of them); every replica gets the sum."""
    if len(replicas) == 1 and mesh.group is None:
        return
    params = [list(r.parameters()) for r in replicas]
    live = [i for i, p in enumerate(params[0]) if p.grad is not None]
    if not live:
        return
    home = params[0][0].device
    grads = []
    for i in live:
        g = params[0][i].grad
        for rep in params[1:]:
            g = g + rep[i].grad.to(home)
        grads.append(g)
    if mesh.group is not None:
        flat = all_reduce_processes(torch.cat([g.reshape(-1) for g in grads]), mesh)
        grads = [f.view_as(g) for f, g in zip(flat.split([g.numel() for g in grads]), grads)]
    for rep in params:
        for i, g in zip(live, grads):
            if rep[i].grad is not g:
                rep[i].grad.copy_(g)

"""Distributed k-means: Lloyd's iterations over a row-sharded point set.

Port of ``image_search_engine_tpu/parallel/kmeans.py``. The points are
split into the mesh's row blocks; every shard assigns its block to the
centroids with ``ops/kmeans.assign`` (the 3xTF32 assignment kernel on the
card) and contributes per-cluster partial sums and counts, which add up
on the home device and, across processes, with one ``all_reduce`` each.
The update is then the same in every process, so the centroids stay
replicated with no broadcast. Semantics match ``ops/kmeans.lloyd``
(spherical renormalization, empty clusters keep their centroid); padding
rows carry weight 0. The sums add in another order than the unsharded
run's, so centroids agree with it to a few f32 ulps of the cluster sums.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.ops.kmeans import _generator, _random_rows, assign
from image_search_engine_tpu_torch.parallel.mesh import Mesh, all_reduce_processes, shard_rows

_ROWS = 1 << 16  # rows per weighted partial-sum pass (bounds the x * w temporary)


def _shard_stats(x: torch.Tensor, w: torch.Tensor, c: torch.Tensor, k: int):
    """One shard's weighted (sums (k, d), counts (k,), weighted squared
    distances) to its nearest centroid."""
    codes, dists = assign(x, c)
    codes = codes.long()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], _ROWS):
        sums.index_add_(0, codes[s:s + _ROWS], x[s:s + _ROWS] * w[s:s + _ROWS, None])
    counts = torch.zeros(k, dtype=torch.float32, device=x.device).index_add_(0, codes, w)
    return sums, counts, (dists.double() * w.double()).sum()


def _global_stats(x_shards, w_shards, c, k, mesh: Mesh):
    home = mesh.home
    sums = torch.zeros((k, c.shape[1]), dtype=torch.float32, device=home)
    counts = torch.zeros(k, dtype=torch.float32, device=home)
    inertia = torch.zeros((), dtype=torch.float64, device=home)
    for x, w in zip(x_shards, w_shards):
        s, n, e = _shard_stats(x, w, c.to(x.device), k)
        sums += s.to(home)
        counts += n.to(home)
        inertia += e.to(home)
    return (all_reduce_processes(sums, mesh), all_reduce_processes(counts, mesh),
            all_reduce_processes(inertia, mesh))


def lloyd_sharded(x_shards: Sequence[torch.Tensor], weights_shards: Sequence[torch.Tensor],
                  init_centroids: torch.Tensor, k: int, mesh: Mesh, niter: int = 25,
                  spherical: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed Lloyd iterations.

    Args:
      x_shards: this process's (Npad/S, d) blocks of the points
        (parallel/mesh.shard_rows); padding rows must carry weight 0.
      weights_shards: their (Npad/S,) weights, 1.0 for real rows.
      init_centroids: (k, d) initial centroids.
      k: number of centroids.
      mesh: the 1-D mesh.
    Returns:
      (centroids (k, d) f32, inertia float64) on ``mesh.home``; the
      inertia is that of the returned centroids.
    """
    x_shards = [x.float() for x in x_shards]
    w_shards = [w.float() for w in weights_shards]
    c = init_centroids.float().to(mesh.home)
    for _ in range(niter):
        sums, counts, _ = _global_stats(x_shards, w_shards, c, k, mesh)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        c = torch.where(counts[:, None] > 0, new, c)
        if spherical:
            c = l2_normalize(c)
    return c, _global_stats(x_shards, w_shards, c, k, mesh)[2]


def kmeans_fit_sharded(x, k: int, mesh: Mesh, *, niter: int = 25, nredo: int = 3,
                       seed: int = 42, spherical: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook training with restarts over the mesh (faiss.Kmeans
    semantics): pads and shards the points, runs ``nredo`` restarts and
    returns the best (centroids (k, d), inertia). The restarts draw their
    inits as ``ops/kmeans.kmeans_fit`` does, from one generator seeded with
    ``seed`` on the home device, so a sharded and an unsharded run on that
    device start from the same centroids."""
    x = torch.as_tensor(np.asarray(x, np.float32) if isinstance(x, np.ndarray) else x)
    x = x.to(device=mesh.home, dtype=torch.float32)
    if spherical:
        x = l2_normalize(x)
    n = x.shape[0]
    r = -(-n // mesh.size)
    w = torch.ones(n, dtype=torch.float32, device=mesh.home)
    xs, ws = shard_rows(x, mesh, r), shard_rows(w, mesh, r)
    gen = _generator(seed, mesh.home)
    best_c, best_inertia = None, float("inf")
    for _ in range(nredo):
        init = x[_random_rows(n, k, gen, mesh.home)]
        if spherical:
            init = l2_normalize(init)
        c, inertia = lloyd_sharded(xs, ws, init, k, mesh, niter=niter, spherical=spherical)
        if best_c is None or float(inertia) < best_inertia:
            best_c, best_inertia = c, float(inertia)
    return best_c, torch.tensor(best_inertia, dtype=torch.float64)

"""K-means codebook training: Lloyd's iterations on a torch device.

Port of ``image_search_engine_tpu/ops/kmeans.py`` (with the assignment
kernel of ``ops/kmeans_pallas.py``):

  * assignment = nearest centroid by ``||c||^2 - 2 x.c``, argmin and min,
    then ``+||x||^2`` clamped at 0. On CUDA tensors ``assign`` launches the
    hand-written kernel (``csrc/kmeans_assign.cu``), which keeps the (N, K)
    distances out of device memory; on CPU tensors it runs ``assign_ref``;
  * update = mean of the assigned points by ``index_add_`` (a segment sum;
    the JAX package's one-hot matmul was a TPU scatter workaround). Empty
    clusters keep their previous centroid. On CUDA the float atomics sum in
    a run-dependent order, so centroids agree with the JAX package's to a
    few f32 ulps of the cluster sums, not bit for bit;
  * spherical mode L2-renormalizes the centroids every iteration;
  * ``nredo`` restarts draw their inits from one explicit
    ``torch.Generator``; the lowest final inertia wins. The generator draws
    other rows than ``jax.random`` from the same seed, so a port-trained
    codebook differs from a JAX-trained one; tests feed both the same init.

``KMeans(k).fit(x)`` exposes ``cluster_centers_`` / ``inertia_`` and
``transform(x)`` = nearest-centroid codes, as the JAX package's facade.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.ops.topk import _on_cuda, _stream
from image_search_engine_tpu_torch.utils.device import resolve_device

_NORM_ROWS = 1 << 16  # rows per ||x||^2 pass (bounds the squared temporary)


def _batched(x: torch.Tensor, centroids: torch.Tensor):
    """(x (B, N, d), centroids (B, K, d), had a batch dim)."""
    if x.dim() != centroids.dim() or x.dim() not in (2, 3):
        raise ValueError(f"want x (N, d) and centroids (K, d), or both batched, got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    if x.dim() == 2:
        return x[None], centroids[None], False
    if x.shape[0] != centroids.shape[0]:
        raise ValueError(f"batch {x.shape[0]} vs {centroids.shape[0]}")
    return x, centroids, True


def assign(x: torch.Tensor, centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: (codes int32, squared distances f32),
    shape (N,) for x (N, d) against centroids (K, d), or (B, N) for a batch
    of B independent problems, x (B, N, d) against centroids (B, K, d).
    Ties go to the lowest centroid index, as ``jnp.argmin``.

    Replaces ``_assign_kernel`` (image_search_engine_tpu/ops/
    kmeans_pallas.py:26, via ``assign_pallas`` :48). What bounds it on the
    card: 2*B*N*K*d flops in IEEE f32 on the CUDA cores (no TF32), against
    N*d*4 bytes of points; at the coarse quantizer's shape (N = 1M, K =
    1024, d = 2048) that is ~1 flop per 4 bytes times K/2, far past the
    memory roofline, so it is compute-bound. The design: a block owns 64
    rows, stages 64-row x 16-column tiles of points and centroids in shared
    memory, keeps a 4 x 4 register tile of dot products per thread and a
    running (min, argmin) per row in registers across all K, so the (N, K)
    distances never reach device memory (what the TPU kernel keeps out of
    HBM). The batch dimension covers the PQ books (B = m subspaces).

    ``x`` may be a strided view whose last dimension is contiguous (the PQ
    residuals' (m, N, dsub) view of an (N, m, dsub) tensor); centroids are
    made contiguous.
    """
    xb, cb, batched = _batched(x, centroids)
    xb = xb.float()
    cb = cb.float().contiguous()
    if not _on_cuda(xb, cb):
        codes, dists = assign_ref(xb, cb)
    else:
        codes, partial = _assign_kernel(xb, cb)
        dists = torch.clamp(partial + _row_sq_norms(xb), min=0.0)
    return (codes, dists) if batched else (codes[0], dists[0])


def _row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(B, N, d) -> (B, N) f32 squared row norms, in chunks of rows."""
    out = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[1], _NORM_ROWS):
        xc = x[:, s:s + _NORM_ROWS]
        out[:, s:s + _NORM_ROWS] = (xc * xc).sum(-1)
    return out


def _assign_kernel(x: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: (codes (B, N) int32, partial mins (B, N) f32,
    ``||c||^2 - 2 x.c`` without the ``||x||^2`` term)."""
    nb, n, d = x.shape
    k = c.shape[1]
    if k == 0:
        raise ValueError("no centroids")
    if x.stride(2) != 1:
        raise ValueError("x's last dimension must be contiguous")
    cn = (c * c).sum(-1).contiguous()
    codes = torch.empty((nb, n), dtype=torch.int32, device=x.device)
    mins = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    if n == 0 or nb == 0:
        return codes, mins
    vec = 4 if (d % 4 == 0 and x.stride(0) % 4 == 0 and x.stride(1) % 4 == 0
                and x.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0) else 1
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_kmeans_assign(
            x.data_ptr(), c.data_ptr(), cn.data_ptr(), codes.data_ptr(), mins.data_ptr(),
            nb, n, k, d, x.stride(0), x.stride(1), vec, _stream(x))
    _kernels.check(err, "kmeans_assign")
    assign.launches += 1
    return codes, mins


assign.launches = 0


def assign_ref(x: torch.Tensor, centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`assign` (the JAX package's ``assign_jax``):
    ``cn - 2 x.cᵀ``, argmin and min, then ``+||x||^2`` clamped at 0."""
    xb, cb, batched = _batched(x, centroids)
    xb, cb = xb.float(), cb.float()
    cn = (cb * cb).sum(-1)
    partial = cn[:, None, :] - 2.0 * torch.matmul(xb, cb.transpose(1, 2))
    mins, codes = partial.min(dim=2)  # first index among equal minima
    dists = torch.clamp(mins + _row_sq_norms(xb), min=0.0)
    codes = codes.to(torch.int32)
    return (codes, dists) if batched else (codes[0], dists[0])


def _update(x: torch.Tensor, codes: torch.Tensor, k: int,
            prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Centroid update: mean of the assigned points; empty clusters keep
    ``prev``. Returns (centroids (k, d), counts (k,) f32)."""
    idx = codes.long()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, idx, x)
    counts = torch.bincount(idx, minlength=k).to(torch.float32)
    new = sums / torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, new, prev), counts


def lloyd(x: torch.Tensor, init_centroids: torch.Tensor, k: int, niter: int = 25,
          spherical: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``niter`` Lloyd iterations from ``init_centroids``: (centroids (k, d),
    inertia = sum of squared distances to the returned centroids)."""
    x = x.float()
    c = init_centroids.float()
    for _ in range(niter):
        codes, _ = assign(x, c)
        c, _ = _update(x, codes, k, c)
        if spherical:
            c = l2_normalize(c)
    _, dists = assign(x, c)
    return c, dists.double().sum()


def _random_rows(n: int, k: int, gen: torch.Generator, device) -> torch.Tensor:
    """k distinct row indices (with replacement when n < k)."""
    if n >= k:
        return torch.randperm(n, generator=gen, device=device)[:k]
    return torch.randint(0, n, (k,), generator=gen, device=device)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def kmeans_fit(x: torch.Tensor, k: int, *, niter: int = 25, nredo: int = 3, seed: int = 42,
               spherical: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codebook training with restarts (faiss.Kmeans semantics): (best
    centroids (k, d), best inertia). The restarts' inits are k distinct
    rows each, drawn in turn from one ``torch.Generator`` seeded with
    ``seed`` on x's device."""
    x = x.float()
    if spherical:
        x = l2_normalize(x)
    gen = _generator(seed, x.device)
    best_c, best_inertia = None, float("inf")
    for _ in range(nredo):
        init = x[_random_rows(x.shape[0], k, gen, x.device)]
        if spherical:
            init = l2_normalize(init)
        c, inertia = lloyd(x, init, k, niter=niter, spherical=spherical)
        if best_c is None or float(inertia) < best_inertia:
            best_c, best_inertia = c, float(inertia)
    return best_c, torch.tensor(best_inertia, dtype=torch.float64)


def subspace_kmeans(resid: torch.Tensor, k: int = 256, niter: int = 20, seed: int = 42,
                    chunk: int = 65536) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train all m product-quantizer codebooks as one batched problem.

    resid (N, m, dsub) -> (books (m, k, dsub) f32, codes (N, m) int32).
    Each Lloyd step assigns chunks of ``chunk`` rows of all m subspaces in
    one batched ``assign`` (B = m) on the (m, N, dsub) view of ``resid``
    (no transposed copy), then sums each subspace's points into its
    centroids. Chunking bounds the plain version's (m, chunk, k) score
    matrix; the kernel keeps none.
    """
    resid = resid.float()
    n, m, dsub = resid.shape
    x = resid.transpose(0, 1)  # (m, N, dsub), last dim contiguous
    gen = _generator(seed, resid.device)
    books = torch.stack([x[b][_random_rows(n, k, gen, resid.device)] for b in range(m)])
    offs = (torch.arange(m, device=resid.device) * k)[:, None]

    for _ in range(niter):
        sums = torch.zeros((m * k, dsub), dtype=torch.float32, device=resid.device)
        counts = torch.zeros(m * k, dtype=torch.float32, device=resid.device)
        for s in range(0, n, chunk):
            xc = x[:, s:s + chunk]
            codes, _ = assign(xc, books)
            flat = (codes.long() + offs).reshape(-1)
            sums.index_add_(0, flat, xc.reshape(-1, dsub))
            counts += torch.bincount(flat, minlength=m * k).to(torch.float32)
        new = (sums / torch.clamp(counts, min=1.0)[:, None]).view(m, k, dsub)
        books = torch.where(counts.view(m, k, 1) > 0, new, books)

    codes = torch.cat([assign(x[:, s:s + chunk], books)[0] for s in range(0, n, chunk)], dim=1)
    return books, codes.transpose(0, 1).contiguous()


@dataclasses.dataclass
class KMeans:
    """sklearn-style facade: ``fit`` / ``transform``, ``cluster_centers_``
    (host numpy), ``inertia_``; ``transform`` returns nearest-centroid
    codes (N, 1). Runs on ``device`` (CUDA unless the caller asks for the
    CPU; raises when CUDA is asked for and absent)."""

    n_clusters: int
    niter: int = 25
    nredo: int = 3
    seed: int = 42
    spherical: bool = True
    device: str | torch.device = "cuda"

    cluster_centers_: Optional[np.ndarray] = None
    inertia_: Optional[float] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def fit(self, x) -> "KMeans":
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        c, inertia = kmeans_fit(x, self.n_clusters, niter=self.niter, nredo=self.nredo,
                                seed=self.seed, spherical=self.spherical)
        self.cluster_centers_ = c.cpu().numpy()
        self.inertia_ = float(inertia)
        return self

    def transform(self, x) -> np.ndarray:
        if self.cluster_centers_ is None:
            raise ValueError("fit first")
        q = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        if self.spherical:
            q = l2_normalize(q)
        codes, _ = assign(q, torch.as_tensor(self.cluster_centers_, device=q.device))
        return codes.cpu().numpy()[:, None]

    def fit_transform(self, x) -> np.ndarray:
        return self.fit(x).transform(x)

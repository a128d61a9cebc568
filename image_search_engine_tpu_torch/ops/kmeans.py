"""K-means codebook training: Lloyd's iterations on a torch device.

Port of ``image_search_engine_tpu/ops/kmeans.py`` (with the assignment
kernel of ``ops/kmeans_pallas.py``):

  * assignment = nearest centroid by ``||c||^2 - 2 x.c``, argmin and min,
    then ``+||x||^2`` clamped at 0. On CUDA tensors ``assign`` launches the
    hand-written kernel (``csrc/kmeans_assign.cu``), which keeps the (N, K)
    distances out of device memory and computes the products on the tensor
    cores with a 3xTF32 split (:func:`tf32_split`), within a few f32 ulps of
    the plain f32 product (not bit for bit: codes may differ only where two
    centroids are that close); on CPU tensors it runs ``assign_ref``, in
    f32 as the JAX package's ``assign_jax``;
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
import torch.nn.functional as F

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.ops.topk import _on_cuda, _stream, tf32_split
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


def assign(x: torch.Tensor, centroids: torch.Tensor,
           split: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-centroid assignment: (codes int32, squared distances f32),
    shape (N,) for x (N, d) against centroids (K, d), or (B, N) for a batch
    of B independent problems, x (B, N, d) against centroids (B, K, d).
    Ties go to the lowest centroid index, as ``jnp.argmin``.

    Replaces ``_assign_kernel`` (image_search_engine_tpu/ops/
    kmeans_pallas.py:26, via ``assign_pallas`` :48), which fuses the product
    with the argmin so the (N, K) distances never reach HBM. What bounds it
    on the card: 2*B*N*K*d operations against N*d*4 bytes of points, so at
    the coarse quantizer's shape (N = 1M, K = 1024, d = 2048) it is
    compute-bound: 62.6 ms at the CUDA cores' f32 rate. The design moves the
    products onto the tensor cores with a 3xTF32 split (each f32 operand a
    = hi + lo in tf32, three products per k-step: hi.lo, lo.hi, hi.hi),
    which keeps about f32's precision at three times the operations of one
    TF32 pass (a 25.4 ms bound); a single TF32 or bf16 pass would keep three
    decimal digits. Hopper's warpgroup MMA does the products: a producer
    warpgroup streams 256-point x 32-column tiles of the points and
    128-centroid tiles of the centroids' two halves (split once per call
    here, by :func:`tf32_split`) into a shared-memory ring with the Tensor
    Memory Accelerator; two consumer warpgroups split the points in
    registers, multiply, and keep a running (min, argmin) per point in
    registers across all K, ties to the lowest index. The batch dimension
    covers the PQ books (B = m subspaces).

    ``x`` may be a strided view whose last dimension is contiguous (the PQ
    residuals' (m, N, dsub) view of an (N, m, dsub) tensor); centroids are
    made contiguous. The kernel's tensor maps take rows of whole 16-byte
    units: other widths are copied zero-padded to d % 4 == 0, which adds
    exactly 0 to every product. ``split``, :func:`centroid_split` of
    ``centroids``, spares the kernel route splitting them again (a serving
    dispatch keeps its codebook's); the plain version ignores it.
    """
    xb, cb, batched = _batched(x, centroids)
    xb = xb.float()
    cb = cb.float().contiguous()
    if not _on_cuda(xb, cb):
        codes, dists = assign_ref(xb, cb)
    else:
        codes, partial = _assign_kernel(xb, cb, split)
        dists = torch.clamp(partial + _row_sq_norms(xb), min=0.0)
    return (codes, dists) if batched else (codes[0], dists[0])


def _row_sq_norms(x: torch.Tensor) -> torch.Tensor:
    """(B, N, d) -> (B, N) f32 squared row norms, in chunks of rows."""
    out = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[1], _NORM_ROWS):
        xc = x[:, s:s + _NORM_ROWS]
        out[:, s:s + _NORM_ROWS] = (xc * xc).sum(-1)
    return out


def _kernel_pad(d: int) -> int:
    """Zero columns that bring a row width d to whole 16-byte units (d % 4
    == 0, at least 4): the kernel's tensor maps take no other rows."""
    return max(4, -(-d // 4) * 4) - d


def centroid_split(centroids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the assignment kernel reads of (K, d) or (B, K, d) centroids:
    (hi, lo) of their 3xTF32 split, zero-padded as :func:`_kernel_pad`
    says, and their squared norms."""
    c = centroids.float()
    cn = (c * c).sum(-1).contiguous()
    return (*tf32_split(F.pad(c, (0, _kernel_pad(c.shape[-1])))), cn)


def _assign_kernel(x: torch.Tensor, c: torch.Tensor,
                   split=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: (codes (B, N) int32, partial mins (B, N) f32,
    ``||c||^2 - 2 x.c`` without the ``||x||^2`` term)."""
    nb, n, d = x.shape
    k = c.shape[1]
    if k == 0:
        raise ValueError("no centroids")
    if x.stride(2) != 1:
        raise ValueError("x's last dimension must be contiguous")
    chi, clo, cn = centroid_split(c) if split is None else split
    codes = torch.empty((nb, n), dtype=torch.int32, device=x.device)
    mins = torch.empty((nb, n), dtype=torch.float32, device=x.device)
    if n == 0 or nb == 0:
        return codes, mins
    # the kernel's tensor maps need d and both strides in whole 16-byte units
    # and 16-byte aligned rows: other shapes go zero-padded to d % 4 == 0,
    # which adds exactly 0 to every product
    pad = _kernel_pad(d)
    if pad:
        x = F.pad(x, (0, pad))
    elif x.stride(0) % 4 or x.stride(1) % 4 or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        err = _kernels.library().ise_kmeans_assign(
            x.data_ptr(), chi.data_ptr(), clo.data_ptr(), cn.data_ptr(), codes.data_ptr(),
            mins.data_ptr(), nb, n, k, x.shape[2], x.stride(0), x.stride(1), _stream(x))
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

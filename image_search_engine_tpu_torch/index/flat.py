"""Flat exact-search index: the IndexFlatL2 / IndexFlatIP / "cosine" / chi2
replacement.

Port of ``image_search_engine_tpu/index/flat.py`` (single device) over f32,
bf16 and int8 stores:

  * "l2"     -> squared-L2 ascending
  * "ip"     -> inner product descending
  * "cosine" -> rows L2-normalized at add time, queries at search time,
                then IP
  * "chi2"   -> chi-square distance ascending (f32 stores only)

Search runs the certified two-phase top-k (ops/topk.py: CUDA kernels on a
CUDA store, their plain versions on the CPU; an int8 store takes the int8
kernels with its per-row scales) and escalates once to a wide candidate
margin when a certificate fails; k > 128 and chi2 take the plain full scan,
the JAX package's own rule. With a mesh (parallel/mesh.py) the store is
row-sharded and searched by ``parallel/topk.distributed_topk``, the same
search per shard and the certificate AND-ed over the shards.
Serialization is the JAX package's ``.npz`` format (int8 adds a ``scales``
key), so an index saved by either package loads in the other.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.index.store import VectorStore, check_store_dtype
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.ops.topk import topk_twophase_safe
from image_search_engine_tpu_torch.parallel.mesh import Mesh
from image_search_engine_tpu_torch.parallel.topk import distributed_topk, local_topk_with_norms
from image_search_engine_tpu_torch.utils.device import resolve_device

log = logging.getLogger(__name__)

WIDE_MARGIN = 32  # escalation margin for certificate violations
MAX_KERNEL_K = 128  # past this, the exact full scan (index/flat.py:109 rule)


def faiss_tail(d: np.ndarray, i: np.ndarray, k: int,
               descending: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Pad (Q, k' < k) host results to k columns as Faiss does: id -1 and
    the worst distance (+inf ascending, -inf descending)."""
    if d.shape[1] >= k:
        return d, i
    pad = ((0, 0), (0, k - d.shape[1]))
    return (np.pad(d, pad, constant_values=-np.inf if descending else np.inf),
            np.pad(i, pad, constant_values=-1))


class FlatIndex:
    """Exact k-NN index over a device-resident store, row-sharded over
    ``mesh`` when one is given (the index then lives on the mesh's devices
    and ``device`` is its home device)."""

    metric_kind = "flat"

    def __init__(self, metric: str = "l2", dtype: str = "f32",
                 device: str | torch.device = "cuda", mesh: Optional[Mesh] = None):
        if metric not in ("l2", "ip", "cosine", "chi2"):
            raise ValueError(f"unsupported metric {metric!r}")
        if metric == "chi2" and dtype != "f32":
            raise ValueError("chi2 searches f32 stores only")
        check_store_dtype(dtype)
        self.metric = metric
        self.dtype = dtype
        self.mesh = mesh
        self.device = mesh.home if mesh is not None else resolve_device(device)
        self.store: VectorStore | None = None

    @property
    def ntotal(self) -> int:
        return 0 if self.store is None else self.store.n

    def add(self, x) -> "FlatIndex":
        """Set the corpus: f32 rows as a numpy array or tensor (a second
        add rebuilds the store with both; an int8 store requantizes its
        dequantized rows, which gives back the same codes)."""
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        if self.metric == "cosine":
            x = l2_normalize(x)
        if self.store is not None:
            x = torch.cat([self.store.values(), x])
        self.store = VectorStore.build(x, dtype=self.dtype, device=self.device, mesh=self.mesh)
        return self

    def search(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN search: host (distances (Q, k), ids (Q, k)). When k > ntotal
        the tail is (-1, +inf) for l2/chi2 and (-1, -inf) for ip/cosine, as
        Faiss pads it."""
        if self.store is None:
            raise ValueError("empty index: add() vectors first")
        q = torch.as_tensor(q).to(device=self.device, dtype=torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        metric = self.metric
        if metric == "cosine":
            q = l2_normalize(q)
            metric = "ip"
        store = self.store
        k_eff = min(k, store.n)
        if self.mesh is not None:
            d, i = self._search_sharded(q, k_eff, metric)
        elif k_eff > MAX_KERNEL_K or metric == "chi2":
            d, i = local_topk_with_norms(q, store.vectors, store.norms, k_eff, metric,
                                         scales=store.scales)
        else:
            d, i = topk_twophase_safe(q, store.vectors, k_eff, metric, x_norms=store.norms,
                                      x_scale=store.scales, wide_margin=WIDE_MARGIN)
        # int32 ids, as the JAX package's FlatIndex and the port's IVF indexes
        # return them (both searches above give int64, topk_flat's contract)
        return faiss_tail(d.cpu().numpy(), i.cpu().numpy().astype(np.int32), k,
                          descending=metric == "ip")

    def _search_sharded(self, q: torch.Tensor, k: int, metric: str):
        """``distributed_topk`` with the certificate enforced: a failure on
        any query re-runs the search at the wide margin; a failure there
        too is logged as an error, as the JAX package's sharded search."""
        store = self.store

        def run(t_margin=None):
            return distributed_topk(q, store.vectors, store.norms, k, metric, self.mesh,
                                    use_kernels=k <= MAX_KERNEL_K and metric != "chi2",
                                    scales_shards=store.scales, with_certificate=True,
                                    t_margin=t_margin)

        d, i, ok = run()
        if not bool(ok.all()):
            d, i, ok = run(WIDE_MARGIN)
            if not bool(ok.all()):
                log.error("sharded exactness certificate still failing after wide-margin "
                          "(%d) escalation on %d/%d queries", WIDE_MARGIN,
                          int((~ok).sum()), ok.numel())
        return d, i

    def save(self, path: str | Path) -> None:
        """The JAX package's ``.npz`` layout (bf16 as uint16 bits; int8 codes
        with their f32 ``scales``)."""
        if self.store is None:
            raise ValueError("empty index: add() vectors first")
        vectors, scales = self.store.to_host_raw()
        extra = {} if scales is None else {"scales": scales}
        np.savez_compressed(
            path, metric=np.array(self.metric), kind=np.array(self.metric_kind),
            dtype=np.array(self.dtype), vectors=vectors, **extra)

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda",
             mesh: Optional[Mesh] = None) -> "FlatIndex":
        with np.load(path, allow_pickle=False) as z:
            dtype = str(z["dtype"]) if "dtype" in z else "f32"
            idx = cls(metric=str(z["metric"]), dtype=dtype, device=device, mesh=mesh)
            vec = z["vectors"]
            scales = z["scales"] if dtype == "int8" else None
        if dtype == "int8":  # the stored codes as they are: no requantization
            idx.store = VectorStore.from_quantized(vec, scales, device=idx.device, mesh=mesh)
            return idx
        if dtype == "bf16":
            vec = torch.from_numpy(vec.view(np.int16)).view(torch.bfloat16).float()
        # rows were normalized at save time for cosine: build, don't re-add
        idx.store = VectorStore.build(vec, dtype=dtype, device=idx.device, mesh=mesh)
        return idx

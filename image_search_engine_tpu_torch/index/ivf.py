"""IVF ("cell-probe") and IVF-PQ indexes on a torch device.

Port of ``image_search_engine_tpu/index/ivf.py`` (single device; the sharded
classes wait for ROADMAP.md queue 1 item 7):

  * coarse quantizer = the k-means trainer of ops/kmeans.py;
  * inverted lists as balanced fixed-width buckets (a cell larger than the
    cap is split into several buckets that duplicate its centroid), stored
    list-contiguous on the device: probing a bucket reads one (cap, d)
    block;
  * ``search``: the plain gather-and-score path; ``search_batched``: the
    probed-scan kernel (ops/ivf.py), no (Q, nprobe*cap, d) gather buffer;
  * IVF-PQ: per-subspace 256-entry codebooks trained on coarse residuals;
    ``search`` scores ADC (a bf16-rounded lookup table summed in f32),
    ``search_batched`` scans the bf16 reconstruction table, which is the
    ADC distance up to bf16 rounding; an optional exact rerank of a
    shortlist from the raw vectors.

``save`` / ``load`` read and write the JAX package's ``.npz`` keys, so an
index built by either package loads in the other. Host-side structure
(centroids, lists, bucket cells, codes, books) is numpy, as in the JAX
package; vectors and the packed tables live on ``device``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.index.store import STORE_DTYPES, _sq_norms
from image_search_engine_tpu_torch.ops import round_up
from image_search_engine_tpu_torch.ops.distances import l2_normalize, stable_smallest
from image_search_engine_tpu_torch.ops.ivf import ivf_probed_topk, rank_buckets
from image_search_engine_tpu_torch.ops.kmeans import KMeans, assign, subspace_kmeans
from image_search_engine_tpu_torch.utils.device import resolve_device

#: bytes of f32 rows per search / pack / rescore chunk (bounds the transients)
_CHUNK_BYTES = 512 << 20


def _pad_results(d: np.ndarray, i: np.ndarray, k: int):
    """Pad (Q, k_eff) results out to (Q, k) with inf/-1 (Faiss semantics
    when fewer than k candidates were probed)."""
    if d.shape[1] >= k:
        return d[:, :k], i[:, :k]
    pad = k - d.shape[1]
    d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
    i = np.pad(i, ((0, 0), (0, pad)), constant_values=-1)
    return d, i


def _build_buckets(codes: np.ndarray, nlist: int,
                   cap_factor: float = 1.3) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced padded inverted lists: cells larger than the cap are split
    into several fixed-width buckets that duplicate the cell's centroid, so
    memory and probe cost scale with ~cap_factor x the mean cell, not the
    largest one. Returns (lists (nbuckets, cap) int32 row ids with -1
    padding, bucket_cell (nbuckets,) int32 owning-cell ids)."""
    n = codes.shape[0]
    counts = np.bincount(codes, minlength=nlist)
    cap = round_up(max(8, int(np.ceil(cap_factor * max(n, 1) / max(nlist, 1)))), 8)
    order = np.argsort(codes, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    lists_rows, bucket_cell = [], []
    for c in range(nlist):
        rows = order[starts[c]: starts[c + 1]]
        nb = max(1, -(-len(rows) // cap))
        for b in range(nb):
            chunk = rows[b * cap: (b + 1) * cap]
            padded = np.full(cap, -1, np.int32)
            padded[: len(chunk)] = chunk
            lists_rows.append(padded)
            bucket_cell.append(c)
    return np.stack(lists_rows), np.asarray(bucket_cell, np.int32)


def _rows_per_chunk(row_bytes: int) -> int:
    return max(1, _CHUNK_BYTES // max(row_bytes, 1))


class IVFIndex:
    """Cell-probe index: coarse k-means partition + probed exact scan."""

    metric_kind = "ivf"

    def __init__(self, metric: str = "l2", nlist: int = 8, nprobe: int = 5, seed: int = 42,
                 table_dtype: str = "f32", device: str | torch.device = "cuda"):
        if metric not in ("l2", "cosine"):
            raise ValueError("IVFIndex supports l2/cosine")
        if table_dtype not in ("f32", "bf16"):
            raise ValueError("IVF table_dtype must be f32 or bf16")
        self.table_dtype = table_dtype
        self.metric = metric
        self.nlist = nlist
        self.nprobe = min(nprobe, nlist)
        self.seed = seed
        self.device = resolve_device(device)
        self.centroids: Optional[np.ndarray] = None  # (nlist, d) cell centroids
        self.bucket_cell: Optional[np.ndarray] = None  # (nbuckets,) cell of each bucket
        self.bucket_centroids: Optional[np.ndarray] = None
        self.vectors: Optional[torch.Tensor] = None  # (N, d) f32 on the device
        self.lists: Optional[np.ndarray] = None  # (nbuckets, cap) int32, -1 pad
        self.list_valid: Optional[np.ndarray] = None
        self.packed: Optional[torch.Tensor] = None  # (nbuckets, cap, d) table dtype
        self.packed_norms: Optional[torch.Tensor] = None  # (nbuckets, cap) f32, +inf pad
        self._dev = None

    @property
    def ntotal(self) -> int:
        return 0 if self.vectors is None else self.vectors.shape[0]

    def _prep(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(device=self.device, dtype=torch.float32)
        if x.dim() == 1:
            x = x[None, :]
        if self.metric == "cosine":
            x = l2_normalize(x)
        return x

    def add(self, x) -> "IVFIndex":
        """Train the coarse quantizer (first add only: Faiss's ``train``
        once, then ``add`` appends) and (re)build the bucketed lists. Later
        adds assign the new rows to the existing cells and re-bucket."""
        self._add(x)
        return self

    def _add(self, x) -> torch.Tensor:
        """``add``'s work; returns every row's coarse cell (int32, on the
        device), which IVF-PQ reuses for its residuals."""
        x = self._prep(x)
        first = self.vectors is None
        if not first:
            x = torch.cat([self.vectors, x])
        self.vectors = x
        if first or self.centroids is None:
            self.centroids = KMeans(n_clusters=self.nlist, niter=25, nredo=3, seed=self.seed,
                                    spherical=False, device=self.device).fit(x).cluster_centers_
        cells = self._assign_cells(x)
        self.lists, self.bucket_cell = _build_buckets(cells.cpu().numpy(), self.nlist)
        self.list_valid = self.lists >= 0
        self._pack()
        return cells

    def _assign_cells(self, x: torch.Tensor) -> torch.Tensor:
        codes, _ = assign(x, torch.as_tensor(self.centroids, device=x.device))
        return codes

    def _pack(self) -> None:
        """List-contiguous table on the device, built in chunks of buckets.
        Norms come from the stored (rounded) values, so the probed scan is
        exact over the table it actually scans."""
        nb, cap = self.lists.shape
        d = self.vectors.shape[1]
        lists = torch.as_tensor(self.lists, device=self.device).long()
        self.packed = torch.zeros((nb, cap, d), dtype=STORE_DTYPES[self.table_dtype],
                                  device=self.device)
        self.packed_norms = torch.full((nb, cap), float("inf"), device=self.device)
        chunk = _rows_per_chunk(cap * d * 4)
        for s in range(0, nb, chunk):
            lst = lists[s:s + chunk]
            valid = lst >= 0
            blk = self.vectors[lst.clamp(min=0)]
            blk[~valid] = 0.0
            self.packed[s:s + chunk] = blk  # casts on assignment (bf16)
            stored = self.packed[s:s + chunk].reshape(-1, d)
            norms = _sq_norms(stored).view(lst.shape)
            self.packed_norms[s:s + chunk] = torch.where(
                valid, norms, torch.full_like(norms, float("inf")))
        self.bucket_centroids = self.centroids[self.bucket_cell]
        self._dev = None

    def _effective_nprobe(self) -> int:
        """Buckets to probe so the expected scanned-row count matches the
        user's cell-denominated nprobe (a cell split into b buckets needs b
        probe slots)."""
        nb = self.lists.shape[0]
        scaled = -(-self.nprobe * nb // self.nlist)
        return int(min(nb, max(self.nprobe, scaled)))

    def _device_arrays(self):
        """(bucket centroids, lists, packed, packed norms) on the device,
        uploaded once."""
        if self._dev is None:
            self._dev = (torch.as_tensor(self.bucket_centroids, device=self.device),
                         torch.as_tensor(self.lists, device=self.device),
                         self.packed, self.packed_norms)
        return self._dev

    def _k_eff(self, k: int, nprobe: int) -> int:
        return min(k, self.ntotal, nprobe * self.lists.shape[1])

    def search(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Probed exact search by gathering the probed buckets (the JAX
        package's ``_ivf_search_kernel``, plain torch here), in chunks of
        queries so the gather stays bounded."""
        if self.vectors is None:
            raise ValueError("add() first")
        q = self._prep(q)
        nprobe = self._effective_nprobe()
        k_eff = self._k_eff(k, nprobe)
        bcents, lists, packed, pnorms = self._device_arrays()
        cap, d = packed.shape[1:]
        outs = []
        step = _rows_per_chunk(nprobe * cap * d * 4)
        for s in range(0, q.shape[0], step):
            qc = q[s:s + step]
            probe = rank_buckets(qc, bcents, nprobe)
            cand = lists[probe].reshape(qc.shape[0], -1)
            vecs = packed[probe].reshape(qc.shape[0], nprobe * cap, d).float()
            vn = pnorms[probe].reshape(qc.shape[0], -1)
            cross = torch.bmm(vecs, qc.to(packed.dtype).float()[:, :, None])[:, :, 0]
            qn = (qc * qc).sum(1, keepdim=True)
            dist = torch.where(cand >= 0, qn - 2.0 * cross + vn,
                               torch.full_like(vn, float("inf")))
            vals, pos = stable_smallest(dist, k_eff)
            ids = torch.gather(cand, 1, pos)
            outs.append((vals, ids, torch.gather(cand >= 0, 1, pos)))
        return self._host_finish(outs, k)

    def search_batched(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batched probed search through the probed-scan kernel; the same
        probes and scanned rows as ``search``."""
        if self.vectors is None:
            raise ValueError("add() first")
        q = self._prep(q)
        nprobe = self._effective_nprobe()
        bcents, lists, packed, pnorms = self._device_arrays()
        out = ivf_probed_topk(q, bcents, packed, pnorms, lists, self._k_eff(k, nprobe), nprobe)
        return self._host_finish([out], k)

    def _host_finish(self, outs, k: int):
        d, i, ok = (torch.cat(parts).cpu().numpy() for parts in zip(*outs))
        i = i.astype(np.int32)
        i[~ok] = -1  # Faiss returns -1 when the probes hold < k candidates
        return self._finish(d, i, k)

    def _finish(self, d: np.ndarray, i: np.ndarray, k: int):
        d, i = _pad_results(d, i, k)
        if self.metric == "cosine":
            # rows are L2-normalized, so L2^2 = 2 - 2 cos: the descending
            # similarity FlatIndex("cosine") returns
            d = np.where(i >= 0, 1.0 - d / 2.0, -np.inf)
        return d, i

    def save(self, path: str | Path) -> None:
        np.savez_compressed(
            path, vectors=self.vectors.cpu().numpy(), centroids=self.centroids,
            lists=self.lists, bucket_cell=self.bucket_cell, metric=np.array(self.metric),
            nprobe=np.int64(self.nprobe), kind=np.array(self.metric_kind),
            table_dtype=np.array(self.table_dtype))

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda") -> "IVFIndex":
        with np.load(path, allow_pickle=False) as z:
            self = cls(metric=str(z["metric"]), nlist=z["centroids"].shape[0],
                       nprobe=int(z["nprobe"]), device=device,
                       table_dtype=str(z["table_dtype"]) if "table_dtype" in z else "f32")
            self.vectors = torch.as_tensor(z["vectors"], device=self.device)
            self.centroids = z["centroids"]
            self.lists = z["lists"]
            self.bucket_cell = z["bucket_cell"]
        self.list_valid = self.lists >= 0
        self._pack()
        return self


def _adc_probe_distances(q: torch.Tensor, cent: torch.Tensor, books: torch.Tensor,
                         codes: torch.Tensor) -> torch.Tensor:
    """One probe slot's ADC distances: q (Q, d); cent (Q, d) the probed
    bucket's centroid per query; books (m, 256, dsub); codes (Q, L, m)
    uint8 -> (Q, L) f32. The residual LUT is rounded to bf16 and its
    entries summed in f32, one subspace at a time, as the JAX package's
    one-hot bf16 einsum does (a one-hot product picks one entry exactly)."""
    nq, d = q.shape
    m, _, dsub = books.shape
    resid = (q - cent).view(nq, m, dsub)
    lut = ((resid * resid).sum(2)[:, :, None]
           - 2.0 * torch.einsum("qmd,mkd->qmk", resid, books)
           + (books * books).sum(2)[None])
    lut = lut.to(torch.bfloat16).float()  # (Q, m, 256)
    dist = torch.zeros(codes.shape[:2], dtype=torch.float32, device=q.device)
    for mm in range(m):
        dist = dist + torch.gather(lut[:, mm], 1, codes[:, :, mm].long())
    return dist


def _pq_reconstruct_table(packed_codes: torch.Tensor, books: torch.Tensor,
                          bucket_centroids: torch.Tensor,
                          list_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decompress list-contiguous PQ codes into a bf16 (nbuckets, cap, d)
    table: recon[b, l] = bf16(centroid[b] + concat_m bf16(books[m,
    codes[b, l, m]])), the sum in f32, then rounded once; norms from the
    bf16 values, +inf at pad slots. Squared L2 to the reconstruction is
    the ADC distance (the subspaces are an orthogonal decomposition), so
    scanning it gives PQ semantics at raw-IVF scan speed. Built in chunks
    of buckets so the f32 transient stays bounded."""
    nb, cap, m = packed_codes.shape
    dsub = books.shape[2]
    d = m * dsub
    books_bf = books.to(torch.bfloat16).float()
    sub = torch.arange(m, device=books.device)
    recon = torch.empty((nb, cap, d), dtype=torch.bfloat16, device=books.device)
    norms = torch.empty((nb, cap), dtype=torch.float32, device=books.device)
    chunk = _rows_per_chunk(cap * d * 4)
    for s in range(0, nb, chunk):
        codes = packed_codes[s:s + chunk].long()  # (c, cap, m)
        rows = books_bf[sub, codes].reshape(codes.shape[0], cap, d)
        blk = (rows + bucket_centroids[s:s + chunk, None, :].float()).to(torch.bfloat16)
        recon[s:s + chunk] = blk
        norms[s:s + chunk] = _sq_norms(blk.reshape(-1, d)).view(-1, cap)
    norms = torch.where(list_valid, norms, torch.full_like(norms, float("inf")))
    return recon, norms


def _exact_rescore(q: torch.Tensor, vectors: torch.Tensor, ids: torch.Tensor,
                   ok: torch.Tensor, k: int):
    """Refine a candidate shortlist against the raw (N, d) store: exact
    distances, final top-k (value, position order)."""
    rows = vectors[ids.long().clamp(min=0)]  # (Q, C, d)
    qn = (q * q).sum(1, keepdim=True)
    cross = torch.bmm(rows, q[:, :, None])[:, :, 0]
    rn = (rows * rows).sum(-1)
    dist = torch.where(ok, qn - 2.0 * cross + rn, torch.full_like(rn, float("inf")))
    vals, pos = stable_smallest(dist, k)
    return vals, torch.gather(ids, 1, pos), torch.gather(ok, 1, pos)


class IVFPQIndex(IVFIndex):
    """IVF + product quantization (the reference's "cell-probe" index): m
    sub-quantizers x 8 bits, residual-encoded; N*m bytes of codes."""

    metric_kind = "ivfpq"

    def __init__(self, metric: str = "l2", nlist: int = 8, nprobe: int = 5, m: int = 16,
                 seed: int = 42, rerank: int = 0, recon_cache: bool = False,
                 device: str | torch.device = "cuda"):
        super().__init__(metric=metric, nlist=nlist, nprobe=nprobe, seed=seed, device=device)
        self.m = m
        # default exact-rerank shortlist (0 = ADC ranking only); needs the
        # raw vectors, which add() keeps and save(store_raw=True) stores
        self.rerank = rerank
        # keep the bf16 reconstruction table resident between
        # search_batched calls (N*d*2 bytes) instead of rebuilding it per call
        self.recon_cache = recon_cache
        self.pq_books: Optional[np.ndarray] = None  # (m, 256, dsub)
        self.codes: Optional[np.ndarray] = None  # (N, m) uint8
        self.packed_codes: Optional[torch.Tensor] = None  # (nbuckets, cap, m) uint8
        self._ntotal: Optional[int] = None  # set when loaded without raw vectors
        self._dev_pq = None
        self._recon_tab = None

    @property
    def ntotal(self) -> int:
        if self.vectors is not None:
            return self.vectors.shape[0]
        if self._ntotal is not None:
            return self._ntotal
        return 0 if self.codes is None else self.codes.shape[0]

    def add(self, x) -> "IVFPQIndex":
        cells = self._add(x).long()  # coarse quantizer + lists (keeps the raw vectors)
        x = self.vectors
        n, d = x.shape
        if d % self.m:
            raise ValueError(f"dim {d} not divisible by m={self.m}")
        dsub = d // self.m
        cents = torch.as_tensor(self.centroids, device=x.device)
        resid = torch.empty_like(x)
        step = _rows_per_chunk(d * 4)
        for s in range(0, n, step):  # no (N, d) centroid gather beside x and resid
            resid[s:s + step] = x[s:s + step] - cents[cells[s:s + step]]
        del cells
        ksub = min(256, max(2, n))
        books_t, codes_t = subspace_kmeans(resid.view(n, self.m, dsub), k=ksub, niter=20,
                                           seed=self.seed)
        del resid
        books = np.zeros((self.m, 256, dsub), np.float32)
        books[:, :ksub] = books_t.cpu().numpy()
        self.pq_books = books
        self.codes = codes_t.cpu().numpy().astype(np.uint8)
        self._pack_codes()
        return self

    def _pack_codes(self) -> None:
        """List-contiguous uint8 codes on the device, mirroring ``_pack``."""
        lists = torch.as_tensor(self.lists, device=self.device).long()
        codes = torch.as_tensor(self.codes, device=self.device)
        packed = codes[lists.clamp(min=0)]
        packed[lists < 0] = 0
        self.packed_codes = packed
        self._dev_pq = None
        self._recon_tab = None

    def _device_arrays_pq(self):
        """(bucket centroids, lists, list_valid, packed codes, books) on the
        device, uploaded once."""
        if self._dev_pq is None:
            self._dev_pq = (torch.as_tensor(self.bucket_centroids, device=self.device),
                            torch.as_tensor(self.lists, device=self.device),
                            torch.as_tensor(self.list_valid, device=self.device),
                            self.packed_codes,
                            torch.as_tensor(self.pq_books, device=self.device))
        return self._dev_pq

    def recon_table(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The bf16 reconstruction table and its norms, kept between calls
        when ``recon_cache`` is set."""
        if self._recon_tab is not None:
            return self._recon_tab
        bcents, _, valid, pcodes, books = self._device_arrays_pq()
        tab = _pq_reconstruct_table(pcodes, books, bcents, valid)
        if self.recon_cache:
            self._recon_tab = tab
        return tab

    def _rerank_size(self, rerank: int, k_eff: int, pool: int) -> int:
        if not rerank:
            return 0
        if self.vectors is None:
            raise ValueError("rerank needs raw vectors; this index holds codes only "
                             "(rebuild or save(store_raw=True))")
        return min(max(rerank, k_eff), pool)

    def search_batched(self, q, k: int,
                       rerank: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """PQ search by scanning the bf16 reconstruction table with the
        probed-scan kernel; results match ``search`` up to the table's bf16
        rounding. With ``rerank`` the shortlist is re-scored exactly from
        the raw vectors."""
        if self.codes is None:
            raise ValueError("add() first")
        rerank = self.rerank if rerank is None else rerank
        q = self._prep(q)
        nprobe = self._effective_nprobe()
        pool = nprobe * self.lists.shape[1]
        k_eff = self._k_eff(k, nprobe)
        c_eff = self._rerank_size(rerank, k_eff, pool)
        bcents, lists, _, _, _ = self._device_arrays_pq()
        recon, norms = self.recon_table()
        out = ivf_probed_topk(q, bcents, recon, norms, lists, c_eff or k_eff, nprobe)
        if c_eff:
            out = _exact_rescore(q, self.vectors, out[1], out[2], k_eff)
        return self._host_finish([out], k)

    def search(self, q, k: int,
               rerank: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """ADC scan; with ``rerank=C`` (or the constructor default) the
        top-C ADC shortlist is re-scored exactly from the raw packed table
        (Faiss's IndexRefineFlat over the cell-probe index)."""
        if self.codes is None:
            raise ValueError("add() first")
        rerank = self.rerank if rerank is None else rerank
        q = self._prep(q)
        nprobe = self._effective_nprobe()
        cap = self.lists.shape[1]
        pool = nprobe * cap
        k_eff = self._k_eff(k, nprobe)
        c_eff = self._rerank_size(rerank, k_eff, pool)
        bcents, lists, valid, pcodes, books = self._device_arrays_pq()
        probe = rank_buckets(q, bcents, nprobe)  # (Q, nprobe)
        nq = q.shape[0]
        dist = torch.cat([_adc_probe_distances(q, bcents[probe[:, p]], books, pcodes[probe[:, p]])
                          for p in range(nprobe)], dim=1)
        cand = lists[probe].reshape(nq, pool)
        ok = valid[probe].reshape(nq, pool)
        dist = torch.where(ok, dist, torch.full_like(dist, float("inf")))
        if c_eff:
            _, pos = stable_smallest(dist, c_eff)
            cell = torch.gather(probe, 1, pos // cap)
            slot = pos % cap
            _, _, packed, pnorms = self._device_arrays()
            rows = packed[cell, slot].float()  # (Q, C, d)
            qn = (q * q).sum(1, keepdim=True)
            cross = torch.bmm(rows, q.to(packed.dtype).float()[:, :, None])[:, :, 0]
            cand = torch.gather(cand, 1, pos)
            ok = torch.gather(ok, 1, pos)
            dist = torch.where(ok, qn - 2.0 * cross + pnorms[cell, slot],
                               torch.full_like(cross, float("inf")))
        vals, pos = stable_smallest(dist, k_eff)
        return self._host_finish(
            [(vals, torch.gather(cand, 1, pos), torch.gather(ok, 1, pos))], k)

    def save(self, path: str | Path, store_raw: bool = False) -> None:
        """Codes-only by default (the compressed index); ``store_raw`` keeps
        the raw vectors for rerank."""
        payload = dict(
            centroids=self.centroids, lists=self.lists, bucket_cell=self.bucket_cell,
            metric=np.array(self.metric), nprobe=np.int64(self.nprobe),
            kind=np.array(self.metric_kind), pq_books=self.pq_books, codes=self.codes,
            ntotal=np.int64(self.ntotal), rerank=np.int64(self.rerank))
        if store_raw:
            payload["vectors"] = self.vectors.cpu().numpy()
        np.savez_compressed(path, **payload)

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = "cuda") -> "IVFPQIndex":
        with np.load(path, allow_pickle=False) as z:
            self = cls(metric=str(z["metric"]), nlist=z["centroids"].shape[0],
                       nprobe=int(z["nprobe"]), m=z["codes"].shape[1], device=device,
                       rerank=int(z["rerank"]) if "rerank" in z.files else 0)
            if "vectors" in z.files:
                self.vectors = torch.as_tensor(z["vectors"], device=self.device)
            self._ntotal = int(z["ntotal"]) if "ntotal" in z.files else None
            self.centroids = z["centroids"]
            self.lists = z["lists"]
            self.bucket_cell = z["bucket_cell"]
            self.pq_books = z["pq_books"]
            self.codes = z["codes"]
        self.list_valid = self.lists >= 0
        self.bucket_centroids = self.centroids[self.bucket_cell]
        self._pack_codes()
        if self.vectors is not None:
            self._pack()
        return self

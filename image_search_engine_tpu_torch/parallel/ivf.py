"""Sharded IVF and IVF-PQ search.

Port of ``image_search_engine_tpu/parallel/ivf.py``. Rows are split into
the mesh's row blocks as in the flat store; every shard keeps the same
coarse centroids (trained globally) but balanced probe buckets over its own
rows only (index/ivf._build_buckets: cells above the width cap split into
buckets that duplicate the cell centroid). A query ranks its shard's
buckets, scans the nprobe best there with the probed-scan kernel
(ops/ivf.ivf_probed_topk), and the per-shard (dist, global id) results
merge as the flat path's do: on the home device over this process's
shards, then over the processes (parallel/topk.merge_processes). Because
the buckets are per shard, results can differ from the unsharded index
near the probe frontier.

``ShardedIVFPQ`` keeps the compression: each shard holds its rows' packed
PQ codes ((nbuckets, cap, m) bytes) with the codebooks; resharding needs no
raw vectors, so a codes-only IVF-PQ artifact scales out as it is. With raw
rows and a rerank shortlist, each shard re-scores its own shortlist
exactly from its row-major block of raw rows, and the merge compares exact
distances.

Every shard holds the same number of buckets of the same width: a shard
with fewer has all-pad buckets whose centroids sit at 1e15, so they rank
last; a shard past the last row block (more shards than blocks) has one.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.index.ivf import (
    _adc_probe_distances, _build_buckets, _pack_table, _pq_reconstruct_table, host_finish)
from image_search_engine_tpu_torch.ops import round_up
from image_search_engine_tpu_torch.ops.distances import l2_normalize, stable_smallest
from image_search_engine_tpu_torch.ops.ivf import ivf_probed_topk, rank_buckets
from image_search_engine_tpu_torch.ops.kmeans import assign
from image_search_engine_tpu_torch.parallel.mesh import Mesh, replicate, shard_rows
from image_search_engine_tpu_torch.parallel.topk import merge_processes

log = logging.getLogger(__name__)

_PAD_CENTROID = 1e15  # where pad buckets' centroids sit: they rank last


def _shard_lists(cells: np.ndarray, n: int, s: int, r: int, nlist: int):
    """Per shard g (lists (nb_g, cap_g) GLOBAL row ids with -1 pads, bucket
    cells (nb_g,)): balanced buckets over rows [g*r, g*r + r)."""
    out = []
    for g in range(s):
        lo, hi = g * r, min((g + 1) * r, n)
        if lo >= n:  # more shards than row blocks: one all-pad bucket
            out.append((np.full((1, 8), -1, np.int32), np.zeros(1, np.int32)))
            continue
        lst, b_cell = _build_buckets(cells[lo:hi], nlist)
        out.append((np.where(lst >= 0, lst + lo, -1).astype(np.int32), b_cell))
    return out


def _merge_shards(dists, ids, k: int, mesh: Mesh):
    """This process's shards' (dist, id) candidates joined on the home
    device in shard order and cut to the best ``k`` (ties to the lowest
    position: the lowest shard, then the shard's own order), with the
    slot validity of the probed families."""
    home = mesh.home
    d = torch.cat([t.to(home) for t in dists], 1)
    i = torch.cat([t.to(home) for t in ids], 1)
    vals, pos = stable_smallest(d, min(k, d.shape[1]))
    ids = torch.gather(i, 1, pos)
    return vals, ids, torch.isfinite(vals) & (ids >= 0)


def _local_exact_rerank(q: torch.Tensor, cand: torch.Tensor, raw: torch.Tensor,
                        raw_norms: torch.Tensor, base: int) -> torch.Tensor:
    """Exact re-score of a shard's candidates (GLOBAL ids, -1 pads) against
    its row-major raw rows (local row = id - base). Pad candidates and pad
    rows (+inf norms) score +inf, so they never win the merge."""
    local = (cand.long() - base).clamp(0, raw.shape[0] - 1)
    rows = raw[local]  # (Q, C, d)
    qn = (q * q).sum(1, keepdim=True)
    cross = torch.bmm(rows, q[:, :, None])[:, :, 0]
    exact = torch.clamp(qn - 2.0 * cross + raw_norms[local], min=0.0)
    return torch.where(cand >= 0, exact, torch.full_like(exact, float("inf")))


class ShardedIVF:
    """Cell-probe index over a mesh, built from rows and global centroids
    (:meth:`from_components`). Each shard holds its rows in the unsharded
    ``IVFIndex``'s list-contiguous layout: (nb, cap, d) bucket blocks in
    the table dtype and (nb, cap) norms, +inf at pad slots."""

    def __init__(self, mesh: Mesh, metric: str = "l2"):
        if metric not in ("l2", "cosine"):
            raise ValueError("ShardedIVF supports l2/cosine")
        self.mesh = mesh
        self.metric = metric
        # this process's shards, each on its device:
        self.bucket_centroids: tuple = ()  # (nb, d) f32, pads at 1e15
        self.lists: tuple = ()  # (nb, cap) int32 global row ids, -1 pads
        self.packed: tuple = ()  # (nb, cap, d) table dtype
        self.packed_norms: tuple = ()  # (nb, cap) f32, +inf at pad slots
        self.n = 0
        self.rows_per_shard = 0
        self.nlist = 0
        self.nbuckets = 0
        self.cap = 0
        self.nprobe = 0

    @property
    def ntotal(self) -> int:
        return self.n

    def _prep_query(self, q) -> torch.Tensor:
        q = torch.as_tensor(q).to(device=self.mesh.home, dtype=torch.float32)
        if q.dim() == 1:
            q = q[None, :]
        return l2_normalize(q) if self.metric == "cosine" else q

    def _host_finish(self, outs, k: int):
        return host_finish(outs, k, self.metric)

    def _place_lists(self, per_shard, centroids: torch.Tensor) -> None:
        """Pad every shard's lists to the common (nb, cap) and place this
        process's shards' lists and bucket centroids (pads far away)."""
        mesh = self.mesh
        cap = max(lst.shape[1] for lst, _ in per_shard)
        nb = max(lst.shape[0] for lst, _ in per_shard)
        d = centroids.shape[1]
        mine = per_shard[mesh.first_shard:mesh.first_shard + mesh.local_size]
        lists, bcents = [], []
        for (lst, b_cell), dev in zip(mine, mesh.devices):
            full = np.full((nb, cap), -1, np.int32)
            full[: lst.shape[0], : lst.shape[1]] = lst
            bc = torch.full((nb, d), _PAD_CENTROID, dtype=torch.float32, device=centroids.device)
            bc[: lst.shape[0]] = centroids[torch.as_tensor(b_cell, device=centroids.device).long()]
            lists.append(torch.as_tensor(full, device=dev))
            bcents.append(bc.to(dev))
        self.lists, self.bucket_centroids = tuple(lists), tuple(bcents)
        self.nbuckets, self.cap = nb, cap

    def _scale_nprobe(self, nprobe: int) -> None:
        # nprobe is cell-denominated; a split cell takes one probe slot per
        # bucket, so scale by buckets over cells (duplicated centroids tie,
        # keeping a split cell's buckets adjacent in the probe order)
        nb = self.nbuckets
        self.nprobe = int(min(nb, max(nprobe, -(-nprobe * nb // self.nlist))))

    @classmethod
    def from_components(cls, x, centroids, nprobe: int, mesh: Mesh, metric: str = "l2",
                        table_dtype: str = "f32") -> "ShardedIVF":
        """Cells by ``ops/kmeans.assign`` (the assignment kernel on the
        card), balanced buckets per shard, and each shard's table packed on
        its device; ``table_dtype="bf16"`` halves the rows' storage, and the
        norms come from the rounded values, so the scan is exact over the
        table it scans."""
        if table_dtype not in ("f32", "bf16"):
            raise ValueError("table_dtype must be f32 or bf16")
        self = cls(mesh, metric)
        home = mesh.home
        x = torch.as_tensor(x).to(device=home, dtype=torch.float32)
        if metric == "cosine":  # idempotent on rows the unsharded index normalized
            x = l2_normalize(x)
        cents = torch.as_tensor(centroids).to(device=home, dtype=torch.float32)
        n = x.shape[0]
        self.nlist = cents.shape[0]
        r = round_up(-(-n // mesh.size), 8)
        cells = assign(x, cents)[0].cpu().numpy()
        per_shard = _shard_lists(cells, n, mesh.size, r, self.nlist)
        self._place_lists(per_shard, cents)
        packed, norms = [], []
        for lst, dev in zip(self.lists, mesh.devices):
            p, nrm = _pack_table(x, lst, table_dtype)
            packed.append(p.to(dev))
            norms.append(nrm.to(dev))
        self.packed, self.packed_norms = tuple(packed), tuple(norms)
        self.n, self.rows_per_shard = n, r
        self._scale_nprobe(nprobe)
        return self

    def k_eff(self, k: int) -> int:
        """k clamped to the rows and to the candidates every shard's probes
        can hold."""
        return min(k, max(1, min(self.n, self.mesh.size * self.nprobe * self.cap)))

    def process_scan(self, q: torch.Tensor, k: int):
        """This process's half of :meth:`search` on prepared queries: each
        shard's probed-scan top-k, merged over the shards; (dist, int32
        ids, ok) on the home device, invalid slots (+inf, -1, False)."""
        kk = min(k, self.nprobe * self.cap)
        dists, ids = [], []
        for bc, packed, norms, lists in zip(self.bucket_centroids, self.packed,
                                            self.packed_norms, self.lists):
            d, i, ok = ivf_probed_topk(q.to(bc.device), bc, packed, norms, lists, kk, self.nprobe)
            dists.append(torch.where(ok, d, torch.full_like(d, float("inf"))))
            ids.append(torch.where(ok, i, torch.full_like(i, -1)))
        return _merge_shards(dists, ids, k, self.mesh)

    def search(self, q, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Host (distances (Q, k), ids (Q, k)): -1 ids where the probes hold
        fewer than k rows; cosine as descending similarity."""
        k_eff = self.k_eff(k)
        out = merge_processes(self.process_scan(self._prep_query(q), k_eff), self.mesh,
                              k_eff, descending=False)
        return self._host_finish([out], k)


class ShardedIVFPQ(ShardedIVF):
    """IVF-PQ over a mesh, compressed: per shard (nb, cap) global-id lists,
    (nb, d) bucket centroids and (nb, cap, m) uint8 packed codes, with the
    (m, 256, dsub) codebooks on every shard's device. Optionally each
    shard's row-major block of raw rows and their norms (+inf at pad rows)
    for the shard-local exact rerank."""

    def __init__(self, mesh: Mesh, metric: str = "l2"):
        super().__init__(mesh, metric)
        self.pq_books: tuple = ()  # (m, 256, dsub) f32 on each shard's device
        self.packed_codes: tuple = ()  # (nb, cap, m) uint8
        self.m = 0
        self.rerank = 0
        self.raw_rows: Optional[tuple] = None  # (r, d) f32 row-major blocks
        self.raw_norms: Optional[tuple] = None  # (r,) f32, +inf at pad rows

    @classmethod
    def from_codes(cls, codes, row_cell, centroids, pq_books, nprobe: int, mesh: Mesh,
                   metric: str = "l2", raw=None, rerank: int = 0) -> "ShardedIVFPQ":
        """From an IVF-PQ artifact's parts: codes (N, m) uint8, every row's
        coarse cell (N,), cell centroids (nlist, d), codebooks (m, 256,
        dsub). No raw vectors needed: a compressed artifact scales out
        compressed. ``raw`` (N, d) with ``rerank`` C adds the exact refine
        on the mesh: each shard re-scores its own top-C shortlist from its
        raw rows."""
        self = cls(mesh, metric)
        home = mesh.home
        codes = torch.as_tensor(np.ascontiguousarray(codes)).to(home)
        row_cell = np.asarray(row_cell)
        cents = torch.as_tensor(centroids).to(device=home, dtype=torch.float32)
        n, self.m = codes.shape
        self.nlist, d = cents.shape
        r = round_up(-(-n // mesh.size), 8)
        per_shard = _shard_lists(row_cell, n, mesh.size, r, self.nlist)
        self._place_lists(per_shard, cents)
        pcodes = []
        for lst, dev in zip(self.lists, mesh.devices):
            lh = lst.to(home).long()
            pc = codes[lh.clamp(min=0)]
            pc[lh < 0] = 0
            pcodes.append(pc.to(dev))
        self.packed_codes = tuple(pcodes)
        self.pq_books = replicate(torch.as_tensor(pq_books).to(device=home, dtype=torch.float32),
                                  mesh)
        if raw is not None:
            raw = torch.as_tensor(raw).to(device=home, dtype=torch.float32)
            self.raw_rows = shard_rows(raw, mesh, r)
            step = max(1, (128 << 20) // max(d * 4, 1))  # rows a pass: no (N, d) square
            norms = torch.cat([(b * b).sum(1) for b in raw.split(step)])
            self.raw_norms = shard_rows(norms, mesh, r, fill=float("inf"))
            self.rerank = int(rerank)
        self.n, self.rows_per_shard = n, r
        self._scale_nprobe(nprobe)
        return self

    @classmethod
    def from_index(cls, index, mesh: Mesh) -> "ShardedIVFPQ":
        """Reshard a loaded ``IVFPQIndex``. Its raw vectors, when the
        artifact has them, carry the exact rerank onto the mesh (per-call
        ``rerank=`` overrides included); a codes-only artifact built with a
        rerank shortlist serves ADC ranking, with a warning."""
        has_raw = index.vectors is not None
        if index.rerank and not has_raw:
            log.warning("ivfpq rerank=%d configured but the artifact is codes-only; the "
                        "sharded index serves ADC ranking (save with store_raw=True / "
                        "--pq-rerank to keep the refine stage)", index.rerank)
        return cls.from_codes(index.codes, index.row_cells(), index.centroids, index.pq_books,
                              index.nprobe, mesh, metric=index.metric,
                              raw=index.vectors if has_raw else None,
                              rerank=index.rerank if has_raw else 0)

    def _check_rerank(self, rerank: int) -> None:
        if rerank and self.raw_rows is None:
            raise ValueError("rerank needs raw vectors on the mesh; rebuild with "
                             "from_codes(raw=...) or an artifact saved store_raw=True")

    def batched_shortlist(self, k_eff: int, rerank: int) -> int:
        """The rerank shortlist of :meth:`search_batched` (0: ADC ranking)."""
        pool = self.nprobe * self.cap
        return min(max(int(rerank), min(k_eff, pool)), pool) if rerank else 0

    def build_recon_tables(self) -> Tuple[tuple, tuple]:
        """Each shard's bf16 reconstruction table (nb, cap, d) and its norms,
        on the shard's device: built once at serving start, so a dispatch
        skips the decompression. N * d * 2 bytes over the mesh while
        resident; the artifact stays codes-only."""
        tabs = [_pq_reconstruct_table(pc, books, bc, lst >= 0)
                for pc, books, bc, lst in zip(self.packed_codes, self.pq_books,
                                              self.bucket_centroids, self.lists)]
        return tuple(t for t, _ in tabs), tuple(nrm for _, nrm in tabs)

    def process_scan_batched(self, q: torch.Tensor, k: int, c: int, recon=None):
        """This process's half of :meth:`search_batched` on prepared
        queries: per shard the probed scan over the reconstruction table
        (``recon``, from :meth:`build_recon_tables`, or built here), the
        optional exact rerank of a ``c``-row shortlist, the shard's top-k;
        merged over the shards as :meth:`ShardedIVF.process_scan`."""
        tables, norms = recon if recon is not None else self.build_recon_tables()
        kk = min(k, self.nprobe * self.cap)
        dists, ids = [], []
        for s, (bc, lists, tab, tn) in enumerate(zip(self.bucket_centroids, self.lists,
                                                     tables, norms)):
            qs = q.to(bc.device)
            d, i, ok = ivf_probed_topk(qs, bc, tab, tn, lists, c or kk, self.nprobe)
            i = torch.where(ok, i, torch.full_like(i, -1))
            if c:
                base = (self.mesh.first_shard + s) * self.rows_per_shard
                d = _local_exact_rerank(qs, i, self.raw_rows[s], self.raw_norms[s], base)
            else:
                d = torch.where(ok, d, torch.full_like(d, float("inf")))
            vals, pos = stable_smallest(d, min(k, d.shape[1]))
            dists.append(vals)
            ids.append(torch.gather(i, 1, pos))
        return _merge_shards(dists, ids, k, self.mesh)

    def search_batched(self, q, k: int, rerank: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Batch-throughput PQ search: each shard decompresses its own codes
        into a bf16 reconstruction table (scanning it is ADC up to bf16
        rounding) for this call and scans it with the probed-scan kernel;
        optional shard-local exact rerank; then the merge."""
        rerank = self.rerank if rerank is None else rerank
        self._check_rerank(rerank)
        k_eff = self.k_eff(k)
        out = self.process_scan_batched(self._prep_query(q), k_eff,
                                        self.batched_shortlist(k_eff, rerank))
        return self._host_finish([merge_processes(out, self.mesh, k_eff, False)], k)

    def search(self, q, k: int, rerank: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """ADC search: per shard the nearest buckets, the per-probe residual
        lookup table summed over the probed codes (index/ivf's
        ``_adc_probe_distances``), the optional shard-local exact rerank of
        the top-C ADC shortlist, the shard's top-k; then the merge."""
        rerank = self.rerank if rerank is None else rerank
        self._check_rerank(rerank)
        q = self._prep_query(q)
        k_eff = self.k_eff(k)
        pool = self.nprobe * self.cap
        c_eff = min(max(int(rerank), k_eff), pool) if rerank else 0
        dists, ids = [], []
        for s, (bc, lists, pcodes, books) in enumerate(zip(
                self.bucket_centroids, self.lists, self.packed_codes, self.pq_books)):
            qs = q.to(bc.device)
            probe = rank_buckets(qs, bc, self.nprobe)  # (Q, nprobe)
            dist = torch.cat([_adc_probe_distances(qs, bc[probe[:, p]], books, pcodes[probe[:, p]])
                              for p in range(self.nprobe)], dim=1)
            cand = lists[probe].reshape(qs.shape[0], pool)
            dist = torch.where(cand >= 0, dist, torch.full_like(dist, float("inf")))
            if c_eff:
                _, spos = stable_smallest(dist, c_eff)
                cand = torch.gather(cand, 1, spos)
                base = (self.mesh.first_shard + s) * self.rows_per_shard
                dist = _local_exact_rerank(qs, cand, self.raw_rows[s], self.raw_norms[s], base)
            vals, pos = stable_smallest(dist, min(k_eff, c_eff or pool))
            dists.append(vals)
            ids.append(torch.gather(cand, 1, pos))
        out = _merge_shards(dists, ids, k_eff, self.mesh)
        return self._host_finish([merge_processes(out, self.mesh, k_eff, False)], k)

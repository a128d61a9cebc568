"""``parallel/ivf.py`` on an 8-shard CPU mesh: ``ShardedIVF`` and
``ShardedIVFPQ`` against the JAX package's on its 8-device virtual mesh
(``impl="xla"``, and its ADC search), at the smallest shapes, and against
the port's own unsharded indexes. Both packages get the same rows and the
port's trained centroids, codes and codebooks, so they build the same
per-shard buckets.

The JAX package's sharded searches run their ``jax.shard_map`` programs
op by op on the CPU (a minute for one IVF-PQ search), so these tests wrap
``jax.shard_map`` in ``jax.jit``: the same program, compiled once.
Tolerances: ids equal (no ties in the random data), distances rtol 1e-5 /
atol 1e-4 (f32 products summed in another order); against the unsharded
port at full probe, ids and distances equal, except after the IVF-PQ
exact rerank, whose row norms the unsharded ADC search reads from its
table (summed in float64) and the shards sum in f32: rtol 1e-5 / atol 1e-4.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.ivf import IVFPQIndex as JaxIVFPQIndex
from image_search_engine_tpu.parallel.ivf import ShardedIVF as JaxShardedIVF
from image_search_engine_tpu.parallel.ivf import ShardedIVFPQ as JaxShardedIVFPQ
from image_search_engine_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex
from image_search_engine_tpu_torch.parallel.ivf import ShardedIVF, ShardedIVFPQ
from image_search_engine_tpu_torch.parallel.mesh import Mesh
from image_search_engine_tpu_torch.serving import fused

MESH = Mesh(["cpu"] * 8)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jit_shard_map(monkeypatch):
    shard_map = jax.shard_map
    monkeypatch.setattr(jax, "shard_map", lambda f, **kw: jax.jit(shard_map(f, **kw)))


def blobs(n: int, d: int = 16, groups: int = 8, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((groups, d)).astype(np.float32) * 3
    x = centers[rng.integers(0, groups, n)] + rng.standard_normal((n, d)).astype(np.float32)
    q = x[:2] + 0.1 * rng.standard_normal((2, d)).astype(np.float32)
    return x, q


@pytest.mark.parametrize("n,metric", [(300, "l2"), (300, "cosine"), (40, "l2")])
def test_sharded_ivf_matches_the_jax_package(jit_shard_map, n, metric):
    """nlist 8, nprobe 3 (scaled to the buckets), Q = 2; 40 rows over 8
    shards of 8 rows leave three shards with one all-pad bucket."""
    x, q = blobs(n)
    cents = IVFIndex(metric, nlist=8, nprobe=3, device="cpu").add(x).centroids
    port = ShardedIVF.from_components(x, cents, 3, MESH, metric=metric)
    ref = JaxShardedIVF.from_components(x, cents, 3, jax_make_mesh(8), metric=metric)
    assert (port.nbuckets, port.cap, port.nprobe, port.rows_per_shard) == (
        ref.nbuckets, ref.lists.shape[1], ref.nprobe, ref.rows_per_shard)
    assert len(port.lists) == 8 and all(t.dtype == torch.int32 for t in port.lists)
    np.testing.assert_array_equal(np.concatenate([t.numpy() for t in port.lists]),
                                  np.asarray(ref.lists))
    for k in (5, 60):
        pd, pi = port.search(q, k)
        jd, ji = ref.search(q, k, impl="xla")
        assert pi.dtype == np.int32
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shards", [3, 8])
def test_sharded_ivf_at_full_probe_is_the_unsharded_search(table_dtype, shards):
    """Every bucket probed: each side is exact over the same (rounded)
    table values, so the ids and distances are the unsharded index's."""
    x, q = blobs(203)
    one = IVFIndex(nlist=4, nprobe=4, table_dtype=table_dtype, device="cpu").add(x)
    sharded = ShardedIVF.from_components(x, one.centroids, 4, Mesh(["cpu"] * shards),
                                         table_dtype=table_dtype)
    assert sharded.packed[0].dtype == one.packed.dtype
    for k in (10, 250):
        d1, i1 = one.search_batched(q, k)
        d2, i2 = sharded.search(q, k)
        np.testing.assert_array_equal(i2, i1)
        np.testing.assert_array_equal(d2, d1)


def pq_index(rerank=8, n=300, seed=0):
    x, q = blobs(n, seed=seed)
    return IVFPQIndex(nlist=8, nprobe=3, m=4, rerank=rerank, device="cpu").add(x), x, q


@pytest.mark.parametrize("rerank", [0, 8])
def test_sharded_ivfpq_adc_search_matches_the_jax_package(jit_shard_map, rerank):
    """The ADC search from one artifact's codes, cells, centroids and
    codebooks; with raw rows and a shortlist of 8, the shard-local exact
    rerank."""
    pq, x, q = pq_index(rerank)
    port = ShardedIVFPQ.from_index(pq, MESH)
    ref = JaxShardedIVFPQ.from_codes(pq.codes, pq.row_cells(), pq.centroids, pq.pq_books,
                                     pq.nprobe, jax_make_mesh(8), raw=x, rerank=rerank)
    np.testing.assert_array_equal(np.concatenate([t.numpy() for t in port.packed_codes]),
                                  np.asarray(ref.packed_codes))
    for k in (5, 30):
        pd, pi = port.search(q, k)
        jd, ji = ref.search(q, k)
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-4)


def test_row_cells_match_the_jax_package(tmp_path):
    pq, _, _ = pq_index()
    pq.save(tmp_path / "pq.npz")
    np.testing.assert_array_equal(pq.row_cells(),
                                  JaxIVFPQIndex.load(tmp_path / "pq.npz").row_cells())
    assert (pq.row_cells() >= 0).all()


@pytest.mark.parametrize("rerank", [0, 16])
@pytest.mark.parametrize("shards", [3, 8, 64])
def test_sharded_ivfpq_at_full_probe_is_the_unsharded_search(rerank, shards):
    """Every bucket probed: search_batched scans each shard's bf16
    reconstruction table, the unsharded one its own, which hold the same
    values; the ADC search and the exact rerank too."""
    pq, _, q = pq_index(rerank)
    pq.nprobe = pq.nlist
    sharded = ShardedIVFPQ.from_index(pq, Mesh(["cpu"] * shards))
    for k in (5, 40):
        for search in ("search", "search_batched"):
            d1, i1 = getattr(pq, search)(q, k)
            d2, i2 = getattr(sharded, search)(q, k)
            np.testing.assert_array_equal(i2, i1)
            if rerank:
                np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-4)
            else:
                np.testing.assert_array_equal(d2, d1)


def test_a_codes_only_artifact_reshards_without_raw_rows(tmp_path, caplog):
    pq, _, q = pq_index(rerank=8)
    pq.save(tmp_path / "pq.npz")  # codes only
    loaded = IVFPQIndex.load(tmp_path / "pq.npz", mesh=MESH)
    assert loaded.vectors is None and loaded.device == MESH.home
    with caplog.at_level(logging.WARNING):
        sharded = ShardedIVFPQ.from_index(loaded, MESH)
    assert "artifact is codes-only" in caplog.text
    assert sharded.raw_rows is None and sharded.rerank == 0
    np.testing.assert_array_equal(sharded.search(q, 5)[1],
                                  ShardedIVFPQ.from_index(pq, MESH).search(q, 5, rerank=0)[1])
    with pytest.raises(ValueError, match="rerank needs raw vectors"):
        sharded.search_batched(q, 5, rerank=8)


def test_the_served_sharded_families_give_the_search_ids():
    x, q = blobs(300)
    cents = IVFIndex(nlist=8, nprobe=3, device="cpu").add(x).centroids
    sivf = ShardedIVF.from_components(x, cents, 3, MESH)
    pq, _, _ = pq_index(rerank=8)
    spq = ShardedIVFPQ.from_index(pq, MESH)
    emb = torch.from_numpy(q)
    for index, family, search in ((sivf, fused.sharded_ivf_family, sivf.search),
                                  (spq, fused.sharded_ivfpq_family, spq.search_batched)):
        core, statics_fn, epilogue = family(index)
        assert fused.across_processes(index) is None
        for k in (5, 50):
            d, i = epilogue(core(emb, statics_fn(k), None), k, None)
            d2, i2 = search(q, k)
            np.testing.assert_array_equal(i, i2)
            np.testing.assert_array_equal(d, d2)

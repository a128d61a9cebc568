"""The port's IVF and IVF-PQ indexes (image_search_engine_tpu_torch/index/
ivf.py, ops/ivf.py) against the JAX package's (index/ivf.py, ops/
ivf_pallas.py with the Pallas probed scan and select in interpret mode).

The k-means inits differ between the packages (torch.Generator vs
jax.random), so parity goes through a shared artifact: an index built and
saved by one package is loaded by the other and both search it. On the CPU
the port runs the probed scan's plain version; the CUDA kernel is compared
with it on the card by ``chip_smoke.py``.

Tolerances: raw-table distances rtol 1e-5 and an atol of 16 f32 ulps of the
magnitudes that cancel in ||q||^2 - 2 q.x + ||x||^2 (``exact``: f32 scores,
other summation order); bf16-table and ADC distances rtol 1e-2 (a LUT or table
entry may round to the neighbouring bf16 value, 2^-7 relative at most);
ids equal except where the distances tie within that tolerance at the k-th.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.index import ivf as jax_ivf
from image_search_engine_tpu.ops.ivf_pallas import ivf_probed_topk as jax_probed_topk
from image_search_engine_tpu_torch.index import ivf as port_ivf
from image_search_engine_tpu_torch.ops import ivf as port_ops

EXACT = dict(rtol=1e-5, atol=1e-4)
EPS32 = float(np.finfo(np.float32).eps)


def exact(x, q):
    """EXACT widened to the cancellation bound of squared-L2 in f32."""
    xm = float(np.sqrt((x.astype(np.float64) ** 2).sum(1).max()))
    qm = float(np.sqrt((q.astype(np.float64) ** 2).sum(1).max()))
    return dict(rtol=EXACT["rtol"], atol=max(EXACT["atol"], 16 * EPS32 * (xm + qm) ** 2))
BF16 = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def blobs(seed, n=1200, d=32, k=12, nq=12):
    rng = np.random.default_rng(seed)
    cent = (rng.standard_normal((k, d)) * 3).astype(np.float32)
    x = (cent[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)
    q = (cent[rng.integers(0, k, nq)] + rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


def assert_same_results(pd, pi, jd, ji, tol, descending=False):
    """Same -1 slots; distances within tol; ids equal except ties at the k-th."""
    pd, jd = np.asarray(pd, np.float64), np.asarray(jd, np.float64)
    np.testing.assert_array_equal(pi < 0, ji < 0)
    valid = ji >= 0
    np.testing.assert_allclose(pd[valid], jd[valid], **tol)
    for r in range(len(pi)):
        v = valid[r]
        if not v.any():
            continue
        kth = jd[r][v][-1]
        band = tol["atol"] + tol["rtol"] * abs(kth)
        a = set(pi[r][v][np.abs(pd[r][v] - kth) > band].tolist())
        b = set(ji[r][v][np.abs(jd[r][v] - kth) > band].tolist())
        assert a == b, (r, sorted(a ^ b))
        order = -pd[r][v] if descending else pd[r][v]
        assert (np.diff(order) >= -tol["atol"]).all(), r  # sorted best first


@pytest.mark.parametrize("codes_kind", ["uniform", "skewed", "empty_cells"])
def test_build_buckets_bit_identical(codes_kind):
    rng = np.random.default_rng(0)
    if codes_kind == "uniform":
        codes = rng.integers(0, 8, 1000)
    elif codes_kind == "skewed":  # cells several times the cap: split into buckets
        codes = np.minimum(rng.geometric(0.3, 1000) - 1, 7)
    else:
        codes = rng.choice([1, 5], 300)
    pl, pc = port_ivf._build_buckets(codes, 8)
    jl, jc = jax_ivf._build_buckets(codes, 8)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_array_equal(pc, jc)
    assert pl.dtype == jl.dtype and pc.dtype == jc.dtype
    if codes_kind == "skewed":
        assert len(pc) > len(set(pc.tolist()))  # some cell was split


@pytest.fixture(scope="module")
def jax_artifacts(tmp_path_factory):
    """IVF (f32 and bf16 tables, l2 and cosine) and IVF-PQ indexes built by
    the JAX package, saved to .npz."""
    root = tmp_path_factory.mktemp("jax_ivf")
    x, _ = blobs(1)
    out = {}
    for name, idx in (
            ("ivf_f32", jax_ivf.IVFIndex(nlist=8, nprobe=3)),
            ("ivf_bf16", jax_ivf.IVFIndex(nlist=8, nprobe=3, table_dtype="bf16")),
            ("ivf_cosine", jax_ivf.IVFIndex("cosine", nlist=8, nprobe=3))):
        idx.add(x)
        idx.save(root / f"{name}.npz")
        out[name] = (root / f"{name}.npz", idx)
    pq = jax_ivf.IVFPQIndex(nlist=8, nprobe=3, m=8, rerank=32).add(x)
    pq.save(root / "ivfpq.npz", store_raw=True)
    out["ivfpq"] = (root / "ivfpq.npz", pq)
    return out


@pytest.mark.parametrize("name", ["ivf_f32", "ivf_bf16", "ivf_cosine"])
def test_jax_built_ivf_searches_alike_in_the_port(jax_artifacts, name):
    path, jidx = jax_artifacts[name]
    pidx = port_ivf.IVFIndex.load(path, device="cpu")
    assert pidx.lists.shape == jidx.lists.shape and pidx._effective_nprobe() > 3
    _, q = blobs(2)
    tol = BF16 if name == "ivf_bf16" else EXACT
    desc = name == "ivf_cosine"
    jd, ji = jidx.search(q, 10)
    for pd, pi in (pidx.search(q, 10), pidx.search_batched(q, 10)):
        assert pd.shape == pi.shape == (12, 10)
        assert_same_results(pd, pi, jd, ji, tol, descending=desc)
    jd, ji = jidx.search_batched(q, 10)
    assert_same_results(*pidx.search_batched(q, 10), jd, ji, tol, descending=desc)


@pytest.mark.parametrize("rerank", [0, 32])
def test_jax_built_ivfpq_searches_alike_in_the_port(jax_artifacts, rerank):
    path, jidx = jax_artifacts["ivfpq"]
    pidx = port_ivf.IVFPQIndex.load(path, device="cpu")
    assert pidx.rerank == 32 and pidx.ntotal == jidx.ntotal and pidx.vectors is not None
    _, q = blobs(3)
    tol = EXACT if rerank else BF16
    assert_same_results(*pidx.search(q, 10, rerank=rerank), *jidx.search(q, 10, rerank=rerank),
                        tol)
    assert_same_results(*pidx.search_batched(q, 10, rerank=rerank),
                        *jidx.search_batched(q, 10, rerank=rerank), tol)


def test_probed_topk_matches_jax_kernel(jax_artifacts):
    """ops/ivf.ivf_probed_topk against the JAX package's Pallas version
    (interpret mode) on the same bf16 reconstruction table."""
    path, _ = jax_artifacts["ivfpq"]
    pidx = port_ivf.IVFPQIndex.load(path, device="cpu")
    recon, norms = pidx.recon_table()
    bc, lists, _, _, _ = pidx._device_arrays_pq()
    _, q = blobs(4)
    nprobe = pidx._effective_nprobe()
    pd, pi, pok = port_ops.ivf_probed_topk(torch.from_numpy(q), bc, recon, norms, lists, 16,
                                           nprobe)
    recon_j = jnp.asarray(recon.float().numpy()).astype(jnp.bfloat16)
    jd, ji, jok = jax_probed_topk(jnp.asarray(q), jnp.asarray(bc.numpy()), recon_j,
                                  jnp.asarray(norms.numpy()), jnp.asarray(lists.numpy()), 16,
                                  nprobe, interpret=True)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    pi = np.where(pok.numpy(), pi.numpy(), -1)
    ji = np.where(np.asarray(jok), np.asarray(ji), -1)
    assert_same_results(pd.numpy(), pi, np.asarray(jd), ji, EXACT)


def test_port_built_indexes_load_in_jax(tmp_path):
    x, q = blobs(5)
    ivf = port_ivf.IVFIndex(nlist=8, nprobe=3, device="cpu").add(x)
    ivf.save(tmp_path / "ivf.npz")
    jivf = jax_ivf.IVFIndex.load(tmp_path / "ivf.npz")
    np.testing.assert_array_equal(jivf.lists, ivf.lists)
    # norms of the same stored rows: the port sums in f64 and rounds once,
    # numpy sums pairwise in f32, so they agree to an f32 ulp
    np.testing.assert_allclose(jivf.packed_norms, ivf.packed_norms.numpy(), rtol=1e-6)
    assert_same_results(*ivf.search(q, 10), *jivf.search(q, 10), EXACT)

    pq = port_ivf.IVFPQIndex(nlist=8, nprobe=3, m=8, rerank=16, device="cpu").add(x)
    pq.save(tmp_path / "pq.npz", store_raw=True)
    jpq = jax_ivf.IVFPQIndex.load(tmp_path / "pq.npz")
    assert jpq.rerank == 16 and jpq.codes.dtype == np.uint8
    np.testing.assert_array_equal(jpq.codes, pq.codes)
    assert_same_results(*pq.search(q, 10), *jpq.search(q, 10), EXACT)
    assert_same_results(*pq.search(q, 10, rerank=0), *jpq.search(q, 10, rerank=0), BF16)
    # codes-only artifact: no raw vectors, so no rerank, in either package
    pq.save(tmp_path / "codes.npz")
    pcodes = port_ivf.IVFPQIndex.load(tmp_path / "codes.npz", device="cpu")
    assert pcodes.vectors is None and pcodes.ntotal == len(x)
    with pytest.raises(ValueError, match="raw vectors"):
        pcodes.search(q, 5)
    assert_same_results(*pcodes.search_batched(q, 5, rerank=0),
                        *jax_ivf.IVFPQIndex.load(tmp_path / "codes.npz").search_batched(
                            q, 5, rerank=0), BF16)


def test_ivfpq_books_train_on_residuals_to_the_lists_cells():
    """IVFPQIndex.add reuses the coarse cells its lists were built from for
    the residuals: the same lists, books and codes as a separate assign."""
    from image_search_engine_tpu_torch.ops import kmeans as port_kmeans

    x, _ = blobs(5, n=600)
    pq = port_ivf.IVFPQIndex(nlist=8, nprobe=3, m=8, device="cpu").add(x)
    xt, cents = torch.from_numpy(x), torch.from_numpy(pq.centroids)
    cells = port_kmeans.assign(xt, cents)[0].long()
    listed = np.full(len(x), -1)
    for b, rows in enumerate(pq.lists):
        listed[rows[rows >= 0]] = pq.bucket_cell[b]
    np.testing.assert_array_equal(listed, cells.numpy())
    resid = (xt - cents[cells]).view(len(x), 8, 4)
    books, codes = port_kmeans.subspace_kmeans(resid, k=256, niter=20, seed=pq.seed)
    np.testing.assert_array_equal(pq.pq_books, books.numpy())
    np.testing.assert_array_equal(pq.codes, codes.numpy().astype(np.uint8))


def split_cell_index(tmp_path):
    """A JAX IVF index whose cell 0 holds 70% of the rows, so it is split
    into several buckets whose centroids are exact duplicates (cells given,
    not trained, so k-means cannot spread the big cluster); loaded by the
    port too."""
    rng = np.random.default_rng(6)
    cent = (rng.standard_normal((8, 16)) * 5).astype(np.float32)
    lab = np.where(rng.random(800) < 0.7, 0, rng.integers(1, 8, 800))
    x = (cent[lab] + rng.standard_normal((800, 16))).astype(np.float32)
    jidx = jax_ivf.IVFIndex(nlist=8, nprobe=1)
    jidx.vectors, jidx.centroids = x, cent
    jidx.lists, jidx.bucket_cell = jax_ivf._build_buckets(jidx._assign_cells(x), 8)
    jidx.list_valid = jidx.lists >= 0
    jidx._pack()
    jidx.save(tmp_path / "split.npz")
    q = (cent[0] + rng.standard_normal((6, 16))).astype(np.float32)
    return jidx, port_ivf.IVFIndex.load(tmp_path / "split.npz", device="cpu"), q, exact(x, q)


def test_split_cell_bucket_ties_probe_the_lowest_bucket_ids(tmp_path):
    jidx, pidx, q, tol = split_cell_index(tmp_path)
    cells, counts = np.unique(pidx.bucket_cell, return_counts=True)
    big = cells[counts.argmax()]
    nprobe = pidx._effective_nprobe()
    assert counts.max() > nprobe  # the probe boundary cuts through the split cell
    probe = port_ops.rank_buckets(torch.from_numpy(q), torch.from_numpy(pidx.bucket_centroids),
                                  nprobe).numpy()
    split = np.flatnonzero(pidx.bucket_cell == big)
    np.testing.assert_array_equal(probe, np.broadcast_to(split[:nprobe], probe.shape))
    jd, ji = jidx.search(q, 10)
    for pd, pi in (pidx.search(q, 10), pidx.search_batched(q, 10)):
        assert_same_results(pd, pi, jd, ji, tol)
    assert_same_results(*pidx.search_batched(q, 10), *jidx.search_batched(q, 10), tol)


def test_underfull_probe_gets_the_faiss_tail(tmp_path):
    """k past the probed pool: the tail is (-1, +inf) as in the JAX package,
    and pad slots inside probed buckets never surface."""
    x, q = blobs(7, n=200, d=16)
    jidx = jax_ivf.IVFIndex(nlist=8, nprobe=1).add(x)
    jidx.save(tmp_path / "small.npz")
    pidx = port_ivf.IVFIndex.load(tmp_path / "small.npz", device="cpu")
    pool = pidx._effective_nprobe() * pidx.lists.shape[1]
    k = pool + 20
    jd, ji = jidx.search(q, k)
    for pd, pi in (pidx.search(q, k), pidx.search_batched(q, k)):
        assert pd.shape == (12, k) and (pi[:, pool:] == -1).all()
        assert np.isinf(pd[pi < 0]).all() and np.isfinite(pd[pi >= 0]).all()
        assert_same_results(pd, pi, jd, ji, EXACT)


def test_recon_cache_matches_and_is_invalidated_by_add(jax_artifacts):
    path, _ = jax_artifacts["ivfpq"]
    _, q = blobs(8)
    cached = port_ivf.IVFPQIndex.load(path, device="cpu")
    cached.recon_cache = True
    plain = port_ivf.IVFPQIndex.load(path, device="cpu")
    d1, i1 = cached.search_batched(q, 10)
    assert cached._recon_tab is not None and plain._recon_tab is None
    d2, i2 = cached.search_batched(q, 10)
    d0, i0 = plain.search_batched(q, 10)
    assert plain._recon_tab is None
    for d, i in ((d2, i2), (d0, i0)):
        np.testing.assert_array_equal(i, i1)
        np.testing.assert_array_equal(d, d1)
    x, _ = blobs(1)
    cached.add(x[:32])  # mutation: the table is dropped, rebuilt next call
    assert cached._recon_tab is None and cached.ntotal == len(x) + 32
    cached.search_batched(q, 5)
    assert cached._recon_tab is not None


def test_probed_scan_wrapper_uses_the_plain_version_on_cpu():
    rng = np.random.default_rng(9)
    packed = torch.from_numpy(rng.standard_normal((5, 24, 16)).astype(np.float32))
    norms = (packed * packed).sum(-1)
    packed[2, 20:] = 0.0  # pad slots: zero rows, +inf norms
    norms[2, 20:] = float("inf")
    q = torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32))
    probe = torch.tensor([[2, 0], [4, -1], [1, 2]], dtype=torch.int32)
    port_ops.probed_scan.launches = 0
    scores = port_ops.probed_scan(q, packed, norms, probe)
    assert port_ops.probed_scan.launches == 0 and scores.shape == (3, 2 * 24)
    want = norms[2] - 2.0 * (packed[2] @ q[0])
    np.testing.assert_allclose(scores[0, :24].numpy(), want.numpy(), rtol=1e-6, atol=1e-5)
    assert torch.isinf(scores[0, 20:24]).all() and torch.isinf(scores[1, 24:]).all()
    assert not torch.isnan(scores).any() and torch.isfinite(scores[2, :24]).all()
    with pytest.raises(ValueError):  # query not cast to the table dtype
        port_ops.probed_scan(q, packed.to(torch.bfloat16), norms, probe)
    with pytest.raises(ValueError):
        port_ops.probed_scan(q, packed, norms, probe.long())

"""The port's chi2 metric against the JAX package's on the same
numpy-seeded histograms: the pairwise distance, the chunked exact scan, the
chunked top-k, and FlatIndex("chi2") with its ``.npz`` in both directions.

chi2 has no kernel in either package (elementwise, no matmul form): both
scan. Tolerance rtol 1e-5 / atol 1e-6: the same f32 terms summed over d in
another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from image_search_engine_tpu.ops import distances as jax_distances
from image_search_engine_tpu.parallel.topk import local_topk_with_norms as jax_local_topk
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.index.store import VectorStore
from image_search_engine_tpu_torch.ops import distances
from image_search_engine_tpu_torch.parallel.topk import (
    CHI2_CHUNK, PAD_NORM, local_topk_with_norms)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _hists(n, d, nq, seed):
    """Sparse non-negative rows, as BoVW histograms are."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, d)) * (rng.random((n, d)) < 0.4)).astype(np.float32)
    q = (rng.random((nq, d)) * (rng.random((nq, d)) < 0.4)).astype(np.float32)
    return x, q


def test_pairwise_chi2_matches_jax():
    x, q = _hists(300, 24, 5, 0)
    x[3] = 0.0  # an empty histogram: 0 / eps terms
    got = distances.pairwise_chi2(torch.from_numpy(q), torch.from_numpy(x)).numpy()
    want = np.asarray(jax_distances.pairwise_chi2(jnp.asarray(q), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert got.shape == (5, 300) and (got >= 0).all()


def test_chunked_chi2_scan_matches_jax():
    """N = 5,000 > CHI2_CHUNK: the port's Python loop with a running (Q, k)
    merge against JAX's lax.scan, pad rows poisoned with PAD_NORM."""
    n = 5000
    assert n > CHI2_CHUNK
    x, q = _hists(n, 16, 4, 1)
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    norms[::97] = PAD_NORM
    pd, pi, cert = local_topk_with_norms(torch.from_numpy(q), torch.from_numpy(x),
                                         torch.from_numpy(norms), 12, "chi2",
                                         with_certificate=True)
    jd, ji = jax_local_topk(jnp.asarray(q), jnp.asarray(x), jnp.asarray(norms), 12, "chi2")
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert cert.all() and not np.isin(pi.numpy(), np.arange(0, n, 97)).any()


@pytest.mark.parametrize("metric", ["l2", "ip", "chi2"])
def test_topk_flat_chunked_matches_jax(metric):
    x, q = _hists(1000, 12, 3, 2)
    pd, pi = distances.topk_flat_chunked(torch.from_numpy(q), torch.from_numpy(x), 7, metric,
                                         chunk=300)
    jd, ji = jax_distances.topk_flat_chunked(jnp.asarray(q), jnp.asarray(x), 7, metric, chunk=300)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    whole = distances.topk_flat(torch.from_numpy(q), torch.from_numpy(x), 7, metric)
    np.testing.assert_array_equal(pi.numpy(), whole[1].numpy())


@pytest.mark.parametrize("k", [5, 200, 1300])
def test_flat_index_chi2_matches_jax(k):
    """Every k takes the scan; k > ntotal adds the Faiss (-1, +inf) tail.
    Ids agree where distances are distinct (a full ranking holds near-ties
    that the two summation orders may swap)."""
    x, q = _hists(1200, 32, 4, k)
    pd, pi = FlatIndex("chi2", device="cpu").add(x).search(q, k)
    jd, ji = JaxFlatIndex("chi2").add(x).search(q, k)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)
    for r in range(q.shape[0]):
        fin = np.isfinite(jd[r])
        gap = np.diff(jd[r][fin]) > ATOL + RTOL * jd[r][fin][1:]
        distinct = np.concatenate([[True], gap]) & np.concatenate([gap, [True]])
        np.testing.assert_array_equal(pi[r][fin][distinct], ji[r][fin][distinct])
    if k > 1200:
        assert (pi[:, 1200:] == -1).all() and np.isposinf(pd[:, 1200:]).all()


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_chi2_needs_an_f32_store(dtype):
    with pytest.raises(ValueError, match="chi2 searches f32 stores only"):
        FlatIndex("chi2", dtype=dtype, device="cpu")
    with pytest.raises(ValueError, match="chi2 searches f32 stores only"):
        JaxFlatIndex("chi2", dtype=dtype)


def test_chi2_npz_loads_in_the_other_package(tmp_path):
    x, q = _hists(400, 20, 3, 5)
    port = FlatIndex("chi2", device="cpu").add(x)
    jax_idx = JaxFlatIndex("chi2").add(x)
    port.save(tmp_path / "port.npz")
    jax_idx.save(tmp_path / "jax.npz")
    from_port = JaxFlatIndex.load(tmp_path / "port.npz")
    from_jax = FlatIndex.load(tmp_path / "jax.npz", device="cpu")
    assert from_port.metric == "chi2" and from_jax.metric == "chi2"
    np.testing.assert_array_equal(from_jax.store.to_host(), x)
    np.testing.assert_array_equal(np.asarray(from_port.store.vectors)[:400], x)
    np.testing.assert_array_equal(from_jax.search(q, 6)[1], jax_idx.search(q, 6)[1])
    np.testing.assert_array_equal(from_port.search(q, 6)[1], port.search(q, 6)[1])


def test_small_store_scan_breaks_ties_to_the_lowest_id():
    """Duplicated rows tie exactly; both packages rank the lower row id
    first (the port by a stable sort, JAX by lax.top_k)."""
    x, q = _hists(50, 8, 2, 6)
    x = np.concatenate([x, x])
    s = VectorStore.build(x, device="cpu")
    pd, pi = local_topk_with_norms(torch.from_numpy(q), s.vectors, s.norms, 10, "chi2")
    jd, ji = jax_local_topk(jnp.asarray(q), jnp.asarray(np.asarray(s.vectors)),
                            jnp.asarray(np.asarray(s.norms)), 10, "chi2")
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    assert (pi.numpy()[:, 0::2] < 50).all() and (pi.numpy()[:, 1::2] >= 50).all()

"""The port's FlatIndex / VectorStore against the JAX package's on the CPU,
and the shared .npz format in both directions.

The JAX FlatIndex on the CPU takes its exact XLA full scan; the port's
takes the two-phase search through the kernels' plain versions. Both are
exact, so ids agree where distances are distinct and distances agree to
f32 accumulation-order tolerance (rtol 1e-5, atol 1e-4).
"""

import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.index.store import VectorStore
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _data(n=1500, d=48, nq=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [1, 10])
def test_flat_index_matches_jax(metric, k):
    x, q = _data(seed=k)
    pd, pi = FlatIndex(metric, device="cpu").add(x).search(q, k)
    jd, ji = JaxFlatIndex(metric).add(x).search(q, k)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pi, ji)


def test_flat_index_bf16_store_matches_jax():
    x, q = _data()
    pd, pi = FlatIndex("l2", dtype="bf16", device="cpu").add(x).search(q, 10)
    jd, ji = JaxFlatIndex("l2", dtype="bf16").add(x).search(q, 10)
    # both score the query in the cross term as stored: the port casts it
    # to bf16 (as the JAX kernel path does), the JAX XLA scan keeps f32
    jd2, ji2 = JaxFlatIndex("l2", dtype="bf16").add(x).search(
        torch.from_numpy(q).to(torch.bfloat16).float().numpy(), 10)
    np.testing.assert_array_equal(pi, ji2)
    recall = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(pi.tolist(), ji.tolist())])
    assert recall >= 0.9


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_k_above_ntotal_gets_faiss_tail(metric):
    x, q = _data(n=7, d=8, nq=2)
    pd, pi = FlatIndex(metric, device="cpu").add(x).search(q, 10)
    jd, ji = JaxFlatIndex(metric).add(x).search(q, 10)
    np.testing.assert_array_equal(pi, ji)
    assert (pi[:, 7:] == -1).all()
    assert np.isinf(pd[:, 7:]).all() and (np.sign(pd[:, 7:]) == (1 if metric == "l2" else -1)).all()
    np.testing.assert_allclose(pd[:, :7], jd[:, :7], rtol=RTOL, atol=ATOL)


def test_large_k_takes_the_full_scan():
    x, q = _data(n=400, d=16, nq=3)
    pd, pi = FlatIndex("l2", device="cpu").add(x).search(q, 200)
    jd, ji = JaxFlatIndex("l2").add(x).search(q, 200)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)


def test_store_pads_and_poisons():
    x, _ = _data(n=13, d=8)
    s = VectorStore.build(x, device="cpu")
    assert s.n == 13 and s.n_padded == 16
    assert (s.norms[13:] == PAD_NORM).all()
    np.testing.assert_allclose(s.norms[:13].numpy(), (x.astype(np.float64) ** 2).sum(1), rtol=1e-6)
    np.testing.assert_array_equal(s.to_host(), x)
    b = VectorStore.build(x, dtype="bf16", device="cpu")
    raw, scales = b.to_host_raw()
    assert raw.dtype == np.uint16 and scales is None
    np.testing.assert_array_equal(b.to_host(), torch.from_numpy(x).to(torch.bfloat16).float().numpy())


def test_second_add_appends():
    x, q = _data(n=300, d=16)
    idx = FlatIndex("l2", device="cpu").add(x[:100]).add(x[100:])
    assert idx.ntotal == 300
    np.testing.assert_array_equal(idx.search(q, 5)[1], FlatIndex("l2", device="cpu").add(x).search(q, 5)[1])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_npz_loads_in_the_other_package(tmp_path, dtype, metric):
    x, q = _data(n=500, d=32)
    port = FlatIndex(metric, dtype=dtype, device="cpu").add(x)
    jax_idx = JaxFlatIndex(metric, dtype=dtype).add(x)
    port.save(tmp_path / "port.npz")
    jax_idx.save(tmp_path / "jax.npz")

    from_port = JaxFlatIndex.load(tmp_path / "port.npz")
    from_jax = FlatIndex.load(tmp_path / "jax.npz", device="cpu")
    assert from_port.dtype == dtype and from_jax.dtype == dtype and from_jax.metric == metric
    # each loads exactly what the other stored
    np.testing.assert_array_equal(from_port.store.to_host(), port.store.to_host())
    np.testing.assert_array_equal(from_jax.store.to_host(), jax_idx.store.to_host())
    # cosine rows are normalized by numpy (JAX) and torch (port): ulps apart
    np.testing.assert_allclose(from_jax.store.to_host(), port.store.to_host(), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(from_jax.search(q, 5)[1], port.search(q, 5)[1])


def test_unported_options_raise():
    # chi2 and the int8 store are ported; what still raises is what the
    # JAX package refuses too
    for dtype in ("bf16", "int8"):
        with pytest.raises(ValueError, match="chi2 searches f32 stores only"):
            FlatIndex("chi2", dtype=dtype, device="cpu")
    with pytest.raises(ValueError, match="store dtype"):
        FlatIndex("l2", dtype="int4", device="cpu")

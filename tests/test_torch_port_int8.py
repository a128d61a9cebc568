"""The port's int8 flat store and its two-phase search against the JAX
package's, on the same numpy-seeded inputs.

On the CPU the int8 kernels' wrappers run their plain versions; the CUDA
kernels are held against those on the card by ``chip_smoke.py``.

Tolerances: quantization codes and scales are bit-equal (the same f32
formula, true division, round half to even). The plain versions equal an
int64-product oracle under the same f32 epilogue bit for bit. Distances
against JAX: rtol 1e-5 / atol 1e-4 (the JAX kernel path computes the same
exact integer products but rounds its f32 epilogue in XLA's own way; its
CPU full scan multiplies the dequantized values in f32); ids equal where
distances are distinct, id sets equal apart from ties at the k-th.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from image_search_engine_tpu.index.store import quantize_rows_int8 as jax_quantize_rows
from image_search_engine_tpu.ops.topk_pallas import quantize_store_int8 as jax_quantize_store
from image_search_engine_tpu.ops.topk_pallas import topk_twophase as jax_topk_twophase
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.index.store import VectorStore, quantize_rows_int8
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.ops.distances import l2_normalize
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM, ip_penalty

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def assert_topk_match(pd, pi, jd, ji, rtol=RTOL, atol=ATOL):
    """Distances equal within tolerance; ids equal where distances are
    distinct; id sets equal apart from ties at the k-th distance."""
    np.testing.assert_allclose(pd, jd, rtol=rtol, atol=atol)
    for r in range(jd.shape[0]):
        tol = atol + rtol * np.abs(jd[r])
        gap = np.abs(np.diff(jd[r])) > tol[1:]
        distinct = np.ones(jd.shape[1], bool)
        distinct[1:] &= gap
        distinct[:-1] &= gap
        np.testing.assert_array_equal(pi[r][distinct], ji[r][distinct])
        kth = jd[r][-1]
        assert (set(pi[r][np.abs(pd[r] - kth) > tol].tolist())
                == set(ji[r][np.abs(jd[r] - kth) > tol].tolist()))


def _rows(kind, rng):
    x = rng.standard_normal((40, 24)).astype(np.float32) * 3
    if kind == "zero_row":
        x[5] = 0.0
    elif kind == "half_ties":  # amax 127 -> scale exactly 1: x/scale hits .5 ties
        x[:, 0] = 127.0
        x[:, 1:7] = [0.5, 1.5, 2.5, 3.5, -2.5, -126.5]
    elif kind == "tiny":
        x *= 1e-30
    return x


@pytest.mark.parametrize("kind", ["random", "zero_row", "half_ties", "tiny"])
def test_quantization_bit_equal_to_jax(kind):
    x = _rows(kind, np.random.default_rng(4))
    codes, scales = quantize_rows_int8(torch.from_numpy(x))
    jc, js = jax_quantize_rows(x)
    sc, ss = jax_quantize_store(jnp.asarray(x))
    for want_c, want_s in ((jc, js), (np.asarray(sc), np.asarray(ss))):
        np.testing.assert_array_equal(codes.numpy(), want_c)
        np.testing.assert_array_equal(scales.numpy().view(np.int32), want_s.view(np.int32))
    if kind == "half_ties":  # round half to even, as numpy and XLA
        np.testing.assert_array_equal(codes[0, :7].numpy(), [127, 0, 2, 2, 4, -2, -126])


def _q8_inputs(rng, n=700, d=37, nq=3):
    codes, scales = quantize_rows_int8(torch.from_numpy(
        rng.standard_normal((n, d)).astype(np.float32)))
    qi, qs = T.quantize_int8(torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)))
    norms = torch.from_numpy(rng.uniform(0, 50, n).astype(np.float32))
    norms[::50] = PAD_NORM
    scales[::50] = 0.0
    return qi, qs, codes, scales, norms


def _oracle_scores(qi, qs, codes, scales, norms):
    """int64 products, then the same f32 epilogue in numpy: (Q, N)."""
    cross = (qi.numpy().astype(np.int64) @ codes.numpy().astype(np.int64).T).astype(np.float32)
    w = (np.float32(2.0) * qs.numpy())[:, None] * scales.numpy()[None, :]
    return norms.numpy()[None, :] - cross * w


def test_q8_plain_versions_equal_int64_oracle():
    qi, qs, codes, scales, norms = _q8_inputs(np.random.default_rng(8))
    want = _oracle_scores(qi, qs, codes, scales, norms)  # (3, 700): 6 groups, ragged last
    padded = np.pad(want, ((0, 0), (0, 6 * 128 - 700)), constant_values=np.inf)
    mins = T.groupmin_q8_ref(qi, qs, codes, scales, norms)
    np.testing.assert_array_equal(mins.numpy(), padded.reshape(3, 6, 128).min(2))
    cand = torch.tensor([[5, 0], [2, 5], [1, 3]], dtype=torch.int32)
    scores = T.rescore_q8_ref(qi, qs, codes, scales, norms, cand).numpy()
    for r in range(3):
        np.testing.assert_array_equal(scores[r], padded[r].reshape(6, 128)[cand[r].numpy()].ravel())
    # the wrappers take the plain versions for CPU tensors and count nothing
    T.reset_launch_counts()
    np.testing.assert_array_equal(T.groupmin_q8(qi, qs, codes, scales, norms).numpy(), mins.numpy())
    np.testing.assert_array_equal(T.rescore_q8(qi, qs, codes, scales, norms, cand).numpy(), scores)
    assert T.launch_counts()["groupmin_q8"] == 0 and T.launch_counts()["rescore_q8"] == 0


def test_q8_exact_where_f32_products_are_not():
    """127^2 * d > 2^24 at d = 2048: an f32 product of the codes would round;
    the plain version's must not."""
    d = 2048
    qi = torch.full((1, d), 127, dtype=torch.int8)
    codes = torch.full((2, d), 127, dtype=torch.int8)
    codes[1, 0] = 126
    one = torch.ones(2)
    mins = T.groupmin_q8_ref(qi, torch.ones(1) * 0.5, codes, one, torch.zeros(2))
    exact = -(127 * 127 * d - 127)  # row 1's product, 1 below row 0's
    assert mins.item() == float(np.float32(-127 * 127 * d))
    scores = T.rescore_q8_ref(qi, torch.ones(1) * 0.5, codes, one, torch.zeros(2),
                              torch.zeros((1, 1), dtype=torch.int32))
    assert scores[0, 1].item() == float(np.float32(exact))


def test_q8_wrappers_check_their_inputs():
    qi, qs, codes, scales, norms = _q8_inputs(np.random.default_rng(1), n=50, d=8, nq=2)
    with pytest.raises(ValueError, match="int8"):
        T.groupmin_q8(qi.float(), qs, codes, scales, norms)
    with pytest.raises(ValueError, match="overflow"):
        wide = torch.zeros((1, T.MAX_Q8_DIM), dtype=torch.int8)
        T.groupmin_q8(wide, torch.ones(1), wide, torch.ones(1), torch.ones(1))
    with pytest.raises(ValueError, match="scales"):
        T.rescore_q8(qi, qs, codes, scales[:-1], norms, torch.zeros((2, 1), dtype=torch.int32))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((50, 8)).astype(np.float32))
    with pytest.raises(ValueError, match="x_scale"):
        T.topk_twophase(x[:2], codes, 5, "l2")
    with pytest.raises(ValueError, match="pre-normalize"):
        T.topk_twophase(x[:2], codes, 5, "cosine", x_scale=scales)
    with pytest.raises(ValueError, match="_q8 kernels"):
        T.groupmin(qi, codes, norms)


# n, d, Q, k, metric, store kind: JAX's Pallas kernels in interpret mode at
# N <= 2048, d <= 64. N = 2048 is 16 groups (the Pallas select runs), N =
# 1500 is 12 (the XLA select), N = 300 has t >= ngroups (no select).
JAX_CASES = [
    (2048, 64, 3, 10, "l2", "plain"),
    (2048, 48, 2, 5, "ip", "plain"),
    (1500, 64, 4, 10, "l2", "ties"),
    (1500, 40, 1, 1, "ip", "pad"),
    (300, 64, 2, 10, "l2", "pad"),
]


@pytest.mark.parametrize("n,d,nq,k,metric,kind", JAX_CASES)
def test_topk_twophase_int8_matches_jax(n, d, nq, k, metric, kind):
    rng = np.random.default_rng(n + d + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if kind == "ties":  # every row repeated ~4 times
        x = x[rng.integers(0, n // 4, n)]
    codes, scales = jax_quantize_rows(x)
    pad = np.zeros(n, bool)
    deq = codes.astype(np.float32) * scales[:, None]
    norms = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    if kind == "pad":  # PAD_NORM rows (zero codes and scales) near the queries
        pad[rng.choice(n, n // 10, replace=False)] = True
        codes[pad], scales[pad], norms[pad] = 0, 0.0, PAD_NORM
        q *= 1e-2

    pd, pi, pc = T.topk_twophase(
        torch.from_numpy(q), torch.from_numpy(codes), k, metric,
        x_norms=torch.from_numpy(norms), x_scale=torch.from_numpy(scales), with_certificate=True)
    jd, ji, jc = jax_topk_twophase(
        jnp.asarray(q), jnp.asarray(codes), k, metric, x_norms=jnp.asarray(norms),
        x_scale=jnp.asarray(scales), with_certificate=True, interpret=True)
    assert_topk_match(pd.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji))
    assert pc.all() and np.asarray(jc).all()
    assert not pad[pi.numpy()].any()


def test_default_norms_are_the_dequantized_stores():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((900, 32)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    store = VectorStore.build(x, dtype="int8", device="cpu")
    codes, scales = store.vectors[:900], store.scales[:900]
    with_norms = T.topk_twophase(q, codes, 7, "l2", x_norms=store.norms[:900], x_scale=scales)
    without = T.topk_twophase(q, codes, 7, "l2", x_scale=scales)
    np.testing.assert_array_equal(with_norms[1].numpy(), without[1].numpy())
    np.testing.assert_allclose(with_norms[0].numpy(), without[0].numpy(), rtol=1e-6)


def _data(n=1500, d=48, nq=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((nq, d)).astype(np.float32))


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [10, 200, 1600])
def test_flat_index_int8_matches_jax(metric, k):
    """k <= 128 takes the two-phase search, k > 128 the full scan, k >
    ntotal adds the Faiss (-1, worst) tail; JAX takes its XLA full scan."""
    x, q = _data(seed=k)
    port = FlatIndex(metric, dtype="int8", device="cpu").add(x)
    if metric == "cosine":
        # JAX normalizes rows in numpy, the port in torch: an ulp apart,
        # which can flip a code at a .5 boundary. Hold the port's cosine
        # against JAX's ip over the port's normalized rows and queries.
        x, q = (l2_normalize(torch.from_numpy(a)).numpy() for a in (x, q))
    jax_idx = JaxFlatIndex("ip" if metric == "cosine" else metric, dtype="int8").add(x)
    np.testing.assert_array_equal(port.store.vectors.numpy(), np.asarray(jax_idx.store.vectors))
    np.testing.assert_array_equal(port.store.scales.numpy(), np.asarray(jax_idx.store.scales))
    np.testing.assert_array_equal(port.store.norms.numpy(), np.asarray(jax_idx.store.norms))
    pd, pi = port.search(q, k)
    jd, ji = jax_idx.search(q, k)
    kv = min(k, 1500)
    assert_topk_match(pd[:, :kv], pi[:, :kv], jd[:, :kv], ji[:, :kv])
    np.testing.assert_array_equal(pi[:, kv:], ji[:, kv:])
    np.testing.assert_array_equal(pd[:, kv:], jd[:, kv:])


def test_second_add_requantizes_exactly():
    x, q = _data(n=700, d=40)
    once = FlatIndex("l2", dtype="int8", device="cpu").add(x)
    twice = FlatIndex("l2", dtype="int8", device="cpu").add(x[:300]).add(x[300:])
    jax_twice = JaxFlatIndex("l2", dtype="int8").add(x[:300]).add(x[300:])
    np.testing.assert_array_equal(twice.store.vectors.numpy(), once.store.vectors.numpy())
    np.testing.assert_array_equal(twice.store.scales.numpy(), once.store.scales.numpy())
    np.testing.assert_array_equal(twice.store.vectors.numpy(), np.asarray(jax_twice.store.vectors))
    np.testing.assert_array_equal(twice.search(q, 5)[1], once.search(q, 5)[1])
    # a dequantized store requantizes to itself
    codes, scales = quantize_rows_int8(once.store.values())
    np.testing.assert_array_equal(codes.numpy(), once.store.vectors[:700].numpy())
    np.testing.assert_array_equal(scales.numpy(), once.store.scales[:700].numpy())


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_int8_npz_loads_in_the_other_package(tmp_path, metric):
    x, q = _data(n=500, d=32)
    port = FlatIndex(metric, dtype="int8", device="cpu").add(x)
    jax_idx = JaxFlatIndex(metric, dtype="int8").add(x)
    port.save(tmp_path / "port.npz")
    jax_idx.save(tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key

    from_port = JaxFlatIndex.load(tmp_path / "port.npz")
    from_jax = FlatIndex.load(tmp_path / "jax.npz", device="cpu")
    assert from_port.dtype == "int8" and from_jax.dtype == "int8"
    np.testing.assert_array_equal(np.asarray(from_port.store.vectors)[:500],
                                  port.store.vectors[:500].numpy())
    np.testing.assert_array_equal(np.asarray(from_port.store.scales)[:500],
                                  port.store.scales[:500].numpy())
    np.testing.assert_array_equal(from_jax.store.vectors.numpy(),
                                  np.asarray(jax_idx.store.vectors))
    np.testing.assert_array_equal(from_jax.store.scales.numpy(), np.asarray(jax_idx.store.scales))
    # the same artifact gives the same ids in either package
    np.testing.assert_array_equal(from_jax.search(q, 5)[1], jax_idx.search(q, 5)[1])
    np.testing.assert_array_equal(from_port.search(q, 5)[1], port.search(q, 5)[1])


def test_ip_penalty_keeps_pad_rows_out():
    """Poisoned rows inside an int8 store (zero codes and scales) never
    enter an ip result, even when every real row scores below them."""
    rng = np.random.default_rng(9)
    x = -np.abs(rng.standard_normal((1000, 16)).astype(np.float32))
    q = np.abs(rng.standard_normal((2, 16)).astype(np.float32))
    store = VectorStore.build(x, dtype="int8", device="cpu")
    pad = torch.arange(0, 1000, 7)
    store.vectors[pad], store.scales[pad], store.norms[pad] = 0, 0.0, PAD_NORM
    d, i = T.topk_twophase(torch.from_numpy(q), store.vectors, 20, "ip",
                           x_norms=store.norms, x_scale=store.scales)
    assert not np.isin(i.numpy(), pad.numpy()).any() and (d.numpy() < 0).all()
    assert (ip_penalty(store.norms)[pad] == PAD_NORM).all()


@pytest.mark.parametrize("nq,t,ngroups,grouped", [
    (1, 24, 1563, False), (21, 24, 1563, False), (32, 24, 1563, False), (33, 24, 1563, True),
    (64, 24, 1563, True), (64, 24, 7813, False), (256, 24, 7813, True), (4096, 12, 157, True),
    (22, 24, 32, True)])
def test_rescore_q8_groups_the_slots_of_batches_that_share_groups(nq, t, ngroups, grouped):
    """rescore_q8's slot order: group order for a batch of at least
    RESCORE_Q8_GROUP_ORDER_MIN_SLOTS slots that number at least half the
    store's groups (a permutation of the slots that keeps every group's
    slots adjacent), else slot order."""
    cand = torch.from_numpy(np.random.default_rng(nq).integers(
        0, ngroups, (nq, t)).astype(np.int32))
    order = T.rescore_q8_order(cand, ngroups)
    if not grouped:
        assert order is None
        return
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order.long()).values, torch.arange(nq * t))
    groups = cand.view(-1)[order.long()]
    assert bool((groups[1:] >= groups[:-1]).all())


def test_group_order_keeps_out_of_range_ids_at_the_ends():
    """group_order's plain version: ids below 0 first, ids past ngroups last,
    a stable permutation of the slots."""
    cand = torch.tensor([[5, -1, 9, 2], [2, 12, 0, -1]], dtype=torch.int32)
    order = T.group_order(cand, 10)
    assert order.tolist() == [1, 7, 6, 3, 4, 0, 2, 5]

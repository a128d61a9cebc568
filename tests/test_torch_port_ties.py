"""Exact ties on the port's flat paths come back in the JAX package's
order, and an ip or cosine distance of zero is +0.0.

A corpus that holds the same image twice gives exact distance ties. The
JAX package breaks them with ``lax.top_k`` (lowest position first): its
full scan (``FlatIndex`` on the CPU, ``topk_flat``) puts the lower row id
first, and its two-phase search the row of the earlier selected candidate
group (groups tie to the lower group id). The port sorts stably in the same
layouts, so its ids must equal the JAX package's exactly, including at the
k-th place. The one exception is a near-tie: two rows of different
content whose distances lie within the tolerance (rtol 1e-5) without being
equal. Their order follows the summation order of the product, which
differs between XLA and PyTorch, as it may between any two BLAS builds.

The store repeats its first half as its second half, starting on a
128-row group boundary, so each duplicated group ties with its twin and
the two-phase order (earlier group first) is also the full scan's (lower
id first). Where duplicates straddle groups the two JAX paths themselves
order ties differently; the port follows the two-phase search there, which
the interpret-mode case below pins.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from image_search_engine_tpu.ops import distances as jax_distances
from image_search_engine_tpu.ops.topk_pallas import topk_twophase as jax_topk_twophase
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.ops import topk_merged as TM
from image_search_engine_tpu_torch.ops.distances import l2_normalize, topk_flat, topk_flat_chunked

HALF, D, NQ = 1536, 64, 4  # 12 groups of 128 rows, then the same 12 again


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def duplicated(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((HALF, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    return np.concatenate([x, x]), q


def assert_ties_ascending(d, i):
    """Within each run of equal distances the ids ascend."""
    for dr, ir in zip(d, i):
        for a in range(len(dr) - 1):
            if dr[a] == dr[a + 1]:
                assert ir[a] < ir[a + 1], (dr[a], ir[a], ir[a + 1])


def assert_ids_match(pd, pi, ji, rtol=1e-5):
    """The port's ids equal JAX's, except where the port's distance lies
    within rtol of a neighbour's held by a row of other content (a
    near-tie that the product's summation order may flip). Exact ties
    between twins (row r and r + HALF) never differ."""
    for r in range(pi.shape[0]):
        for c in np.flatnonzero(pi[r] != ji[r]):
            near = [n for n in (c - 1, c + 1) if 0 <= n < pi.shape[1]
                    and abs(pd[r, n] - pd[r, c]) <= rtol * abs(pd[r, c]) + 1e-6
                    and pi[r, n] % HALF != pi[r, c] % HALF]
            assert near, f"query {r} rank {c}: {pi[r, c]} vs JAX {ji[r, c]}, no near-tie"


@pytest.mark.parametrize("k", [7, 200])
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_flat_index_ties_match_jax(dtype, metric, k):
    """k <= 128 takes the port's two-phase search, k > 128 its full scan;
    the JAX index takes its full scan on the CPU. Ids equal exactly."""
    x, q = duplicated(seed=k)
    port = FlatIndex(metric, dtype=dtype, device="cpu").add(x)
    jmetric = metric
    if metric == "cosine" and dtype == "int8":
        # JAX normalizes in numpy, the port in torch: an ulp apart, which can
        # flip an int8 code at a .5 boundary. Hold the port's cosine against
        # JAX's ip over the port's normalized rows and queries.
        x, q = (l2_normalize(torch.from_numpy(a)).numpy() for a in (x, q))
        jmetric = "ip"
    jax_idx = JaxFlatIndex(jmetric, dtype=dtype).add(x)
    pd, pi = port.search(q, k)
    jd, ji = jax_idx.search(q, k)
    assert_ids_match(pd, pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-4)
    assert (pd[:, :-1] == pd[:, 1:]).any(), "the store must produce exact ties"
    assert_ties_ascending(pd, pi)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_full_scan_ties_match_jax(metric):
    """topk_flat and its chunked merge (chunks cut inside duplicated runs)."""
    x, q = duplicated(seed=3)
    jd, ji = jax_distances.topk_flat(jnp.asarray(q), jnp.asarray(x), 40, metric)
    pd, pi = topk_flat(torch.from_numpy(q), torch.from_numpy(x), 40, metric)
    assert_ids_match(pd.numpy(), pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    cd, ci = topk_flat_chunked(torch.from_numpy(q), torch.from_numpy(x), 40, metric, chunk=1000)
    np.testing.assert_array_equal(ci.numpy(), pi.numpy())
    np.testing.assert_array_equal(cd.numpy(), pd.numpy())


def test_twophase_safe_and_merged_ties():
    """topk_twophase_safe and topk_merged over the duplicated store: the
    JAX full scan's ids, and the merged search equal to the two-phase one
    at its margin bit for bit."""
    x, q = duplicated(seed=5)
    jd, ji = jax_distances.topk_flat(jnp.asarray(q), jnp.asarray(x), 9, "l2")
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    d, i = T.topk_twophase_safe(qt, xt, 9, "l2")
    assert_ids_match(d.numpy(), i.numpy(), np.asarray(ji))
    merged = TM.topk_merged(qt, xt, 9, "l2", with_certificate=True)
    want = T.topk_twophase(qt, xt, 9, "l2", t_margin=2, with_certificate=True)
    for a, b in zip(merged, want):
        assert torch.equal(a, b)
    assert torch.equal(merged[1], i)


@pytest.fixture(scope="module")
def zero_rows_case():
    """The N = 300 probe: rows 0-4 and query 0 zeroed, so l2 ties rows 0-4
    at distance 0 for query 0, and ip ties every row at 0 for it."""
    rng = np.random.default_rng(300)
    x = rng.standard_normal((300, D)).astype(np.float32)
    q = rng.standard_normal((3, D)).astype(np.float32)
    x[:5] = 0.0
    q[0] = 0.0
    return x, q


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_twophase_ties_match_jax_interpret(zero_rows_case, metric):
    """Against the JAX Pallas two-phase search in interpret mode."""
    x, q = zero_rows_case
    jd, ji, jc = jax_topk_twophase(jnp.asarray(q), jnp.asarray(x), 10, metric,
                                   with_certificate=True, interpret=True)
    pd, pi, pc = T.topk_twophase(torch.from_numpy(q), torch.from_numpy(x), 10, metric,
                                 with_certificate=True)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    want0 = [0, 1, 2, 3, 4] if metric == "l2" else list(range(10))
    assert pi[0, :len(want0)].tolist() == want0
    if metric == "ip":  # zero scores are +0.0, as the reference returns them
        assert not np.signbit(pd[0].numpy()).any()


@pytest.mark.parametrize("metric", ["ip", "cosine"])
@pytest.mark.parametrize("k", [5, 200])
def test_zero_distance_serialises_as_positive_zero(zero_rows_case, metric, k):
    x, q = zero_rows_case
    d, _ = FlatIndex(metric, device="cpu").add(x).search(q[:1], k)
    assert (d[0] == 0.0).all()
    assert json.dumps([round(float(v), 6) for v in d[0][:3]]) == "[0.0, 0.0, 0.0]"

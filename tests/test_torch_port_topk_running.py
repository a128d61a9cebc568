"""The port's running-accumulator top-k (image_search_engine_tpu_torch/ops/
topk.py ``topk_running``) against the JAX package's ``topk_pallas``
(ops/topk_pallas.py, Pallas in interpret mode) on the same numpy-seeded
inputs.

On the CPU the port runs the kernel's plain PyTorch version; the CUDA
kernel itself is compared with it on the card by ``chip_smoke.py``.

Tolerance: distances rtol 1e-5 / atol 1e-4, as tests/test_torch_port_topk.py:
both sides score f32 products (the query stays f32 over a bf16 store, whose
values widen to f32 exactly), and only the summation order differs. Ids must
be equal: ties go to the lowest id on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops.topk_pallas import topk_pallas
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def both(q, x, k, metric, x_norms=None, bf16=False, tile_n=256):
    """(port distances, port ids, JAX distances, JAX ids) as numpy."""
    xt = torch.from_numpy(x)
    xj = jnp.asarray(x)
    if bf16:
        xt, xj = xt.to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16)
    pd, pi = T.topk_running(torch.from_numpy(q), xt, k, metric,
                            x_norms=None if x_norms is None else torch.from_numpy(x_norms))
    jd, ji = topk_pallas(jnp.asarray(q), xj, k, metric,
                         x_norms=None if x_norms is None else jnp.asarray(x_norms), tile_n=tile_n)
    assert pi.dtype == torch.int64 and pd.dtype == torch.float32
    return pd.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji)


def assert_same(pd, pi, jd, ji):
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("n,d,nq,k", [(500, 32, 5, 10), (2100, 96, 9, 20)])
def test_topk_running_matches_jax(metric, n, d, nq, k):
    # tests/test_pallas_kernels.py's own shapes
    rng = np.random.default_rng(n + d + nq + k)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    assert_same(*both(q, x, k, metric))


def test_topk_running_single_query_k1_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((1, 16)).astype(np.float32)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    assert_same(*both(q, x, 1, "l2", tile_n=128))


def test_topk_running_duplicate_rows_take_the_lowest_id():
    # every row twice: the distances tie exactly and both sides list the
    # lower id of each pair first
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    x = np.concatenate([x, x])
    q = x[:3] + 0.01 * rng.standard_normal((3, 8)).astype(np.float32)
    pd, pi, jd, ji = both(q, x, 6, "l2", tile_n=128)
    assert_same(pd, pi, jd, ji)
    np.testing.assert_array_equal(pi[:, 0::2] + 64, pi[:, 1::2])


def test_topk_running_bf16_store_keeps_the_query_f32():
    # the query is not rounded to bf16: a bf16-rounded query would shift
    # the scores by far more than the tolerance
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 40)).astype(np.float32)
    x = rng.standard_normal((700, 40)).astype(np.float32)
    pd, pi, jd, ji = both(q, x, 12, "l2", bf16=True)
    assert_same(pd, pi, jd, ji)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    bd, _ = T.topk_running(qb.float(), torch.from_numpy(x).to(torch.bfloat16), 12, "l2")
    assert np.abs(bd.numpy() - pd).max() > 100 * ATOL


def test_topk_running_ip_never_returns_pad_norm_rows():
    # PAD_NORM rows at the origin would win every ip query (score 0 against
    # negative real scores) unless their poisoned norms are honoured
    rng = np.random.default_rng(4)
    x = -np.abs(rng.standard_normal((600, 24)).astype(np.float32))
    pad = rng.choice(600, 60, replace=False)
    x[pad] = 0.0
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    norms[pad] = PAD_NORM
    q = np.abs(rng.standard_normal((3, 24)).astype(np.float32))
    pd, pi, jd, ji = both(q, x, 10, "ip", x_norms=norms)
    assert_same(pd, pi, jd, ji)
    assert not np.isin(pi, pad).any()


@pytest.mark.parametrize("metric,fill", [("l2", np.inf), ("ip", -np.inf)])
def test_topk_running_tail_when_k_exceeds_n(metric, fill):
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    x = rng.standard_normal((50, 16)).astype(np.float32)
    pd, pi, jd, ji = both(q, x, 64, metric, tile_n=128)
    assert_same(pd, pi, jd, ji)
    assert (pi[:, 50:] == -1).all() and (pd[:, 50:] == fill).all()
    assert sorted(pi[0, :50].tolist()) == list(range(50))


def test_topk_running_refuses_k_above_128():
    q = torch.zeros(1, 8)
    x = torch.zeros(300, 8)
    with pytest.raises(ValueError, match="k=129"):
        T.topk_running(q, x, 129)
    with pytest.raises(ValueError):
        topk_pallas(jnp.zeros((1, 8)), jnp.zeros((300, 8)), 129)
    with pytest.raises(ValueError, match="k=0"):
        T.topk_running(q, x, 0)
    with pytest.raises(ValueError, match="store dtype"):
        T.topk_running(q, x.to(torch.int8), 5)


def test_topk_running_wrapper_uses_the_plain_version_on_cpu():
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.standard_normal((3, 20)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((400, 20)).astype(np.float32))
    T.reset_launch_counts()
    for metric in ("l2", "ip", "cosine"):
        got = T.topk_running(q, x, 7, metric)
        want = T.topk_running_ref(q, x, 7, metric)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert T.launch_counts()["topk_running"] == 0


@pytest.mark.parametrize("n,k,nqt,sms,want", [
    (1_000_000, 20, 1, 132, 1056),   # a few waves of blocks over the SMs
    (1_000_000, 20, 8, 132, 132),    # query tiles share the blocks
    (1_000_000, 128, 1, 132, 976),   # each of 8 warps gets >= k rows
    (100, 20, 1, 132, 1),            # a small store is one slice
])
def test_running_slices(n, k, nqt, sms, want):
    assert T._running_slices(n, k, nqt, sms) == want

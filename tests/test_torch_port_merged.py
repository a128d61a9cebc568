"""The port's merged two-phase search (image_search_engine_tpu_torch/ops/
topk_merged.py) against the JAX package's ``topk_merged`` (Pallas in
interpret mode) and against the port's own ``topk_twophase`` at the same
margin.

Each interpret-mode call of the JAX kernel takes tens of seconds on the
CPU, so the JAX side runs twice (l2 and ip, module-scoped). Everything else
is held against the port's ``topk_twophase(t_margin=2)``, which
tests/test_torch_port_topk.py holds against JAX: on the CPU both run the
same plain versions, so they must agree exactly; on the card
``chip_smoke.py`` holds the one-launch kernel to the three kernels bit for
bit.

Tolerance against JAX: distances rtol 1e-5 / atol 1e-4 (same f32 products,
another summation order), ids and certificates equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops.topk_merged import topk_merged as jax_topk_merged
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.ops import topk_merged as TM
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["l2", "ip"])
def jax_case(request):
    """tests/test_topk_merged.py's first shape through both packages."""
    metric = request.param
    rng = np.random.default_rng(8192 + len(metric))
    x = rng.standard_normal((8192, 64)).astype(np.float32)
    q = rng.standard_normal((40, 64)).astype(np.float32)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        port = TM.topk_merged(torch.from_numpy(q), torch.from_numpy(x), 4, metric,
                              with_certificate=True)
    finally:
        torch.set_num_threads(prev)
    ref = jax_topk_merged(jnp.asarray(q), jnp.asarray(x), 4, metric, tile_n=512, t_margin=2,
                          qb_rows=128, with_certificate=True)
    return [t.numpy() for t in port], [np.asarray(t) for t in ref]


def test_topk_merged_matches_jax(jax_case):
    (pd, pi, pc), (jd, ji, jc) = jax_case
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pc, jc)
    assert pc.all()


def make(rng, n, d, nq, dtype):
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dtype)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32))
    return q, x


def assert_equal_outputs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,nq", [(5003, 3), (4096, 17)])
def test_topk_merged_equals_twophase(metric, dtype, n, nq):
    # ragged last group (5003 = 39 * 128 + 11) and Q > 8 (three query tiles)
    rng = np.random.default_rng(n + nq)
    q, x = make(rng, n, 48, nq, dtype)
    got = TM.topk_merged(q, x, 10, metric, with_certificate=True)
    want = T.topk_twophase(q, x, 10, metric, t_margin=2, with_certificate=True)
    assert_equal_outputs(got, want)
    assert got[1].dtype == torch.int64 and bool(got[2].all())


def test_topk_merged_honours_pad_norm_rows():
    rng = np.random.default_rng(9)
    q, x = make(rng, 3000, 32, 5, torch.float32)
    pad = rng.choice(3000, 300, replace=False)
    x[pad] = 0.0
    norms = (x * x).sum(1)
    norms[pad] = PAD_NORM
    q *= 1e-3  # near the origin, where the poisoned zero rows sit
    got = TM.topk_merged(q, x, 8, "l2", x_norms=norms, with_certificate=True)
    assert_equal_outputs(got, T.topk_twophase(q, x, 8, "l2", x_norms=norms, t_margin=2,
                                              with_certificate=True))
    assert not np.isin(got[1].numpy(), pad).any()


def test_topk_merged_rescores_every_group_when_t_reaches_the_group_count():
    # k + t_margin = 12 > ceil(300 / 128) = 3 real groups: the port rescores
    # all three (t = 3, threshold +inf), where the JAX package counts the
    # groups of its tile-padded store; both are exact, so they agree
    rng = np.random.default_rng(10)
    q, x = make(rng, 300, 16, 4, torch.float32)
    norms = (x * x).sum(1)
    scores, cand, threshold, mins = TM.merged_candidates(q, x, norms, 3)
    assert cand.tolist() == [[0, 1, 2]] * 4 and torch.isinf(threshold).all()
    assert scores.shape == (4, 3 * 128) and mins.shape == (4, 3)
    assert torch.isinf(scores[:, 300:]).all() and torch.isfinite(scores[:, :300]).all()
    got = TM.topk_merged(q, x, 10, "l2", with_certificate=True)
    assert_equal_outputs(got, T.topk_twophase(q, x, 10, "l2", t_margin=2, with_certificate=True))
    assert bool(got[2].all())


def test_merged_candidates_select_the_smallest_group_mins():
    rng = np.random.default_rng(11)
    q, x = make(rng, 2000, 24, 6, torch.float32)
    norms = (x * x).sum(1)
    scores, cand, threshold, mins = TM.merged_candidates(q, x, norms, 5)
    want_v, want_c = T.select_topt_ref(mins, 5)
    assert torch.equal(cand, want_c) and torch.equal(threshold, want_v[:, 4])
    assert torch.equal(mins, T.groupmin_ref(q, x, norms))
    assert torch.equal(scores, T.rescore_ref(q, x, norms, cand))
    assert TM.merged_candidates.launches == 0  # the CPU runs the plain version


def test_topk_merged_refuses_what_the_kernel_does_not_take():
    rng = np.random.default_rng(12)
    q, x = make(rng, 1000, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="int8"):
        TM.topk_merged(q, x.to(torch.int8), 5)
    with pytest.raises(ValueError, match="k=129"):
        TM.topk_merged(q, x, 129)
    with pytest.raises(ValueError, match="unsupported metric"):
        TM.topk_merged(q, x, 5, "chi2")
    norms = (x * x).sum(1)
    with pytest.raises(ValueError, match="t=9"):
        TM.merged_candidates(q, x, norms, 9)  # 8 groups
    with pytest.raises(ValueError, match="query dtype"):
        TM.merged_candidates(q.to(torch.bfloat16), x, norms, 4)

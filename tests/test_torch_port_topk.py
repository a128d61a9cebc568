"""The port's two-phase top-k (image_search_engine_tpu_torch/ops/topk.py)
against the JAX package's (ops/topk_pallas.py, Pallas in interpret mode)
on the same numpy-seeded inputs, and against a float64 numpy oracle.

On the CPU the port runs each kernel's plain PyTorch version; the CUDA
kernels themselves are compared with those plain versions on the card by
``chip_smoke.py`` (this directory's conftest imports jax, which the GPU
machine does not have).

Tolerances: f32 stores rtol 1e-5 / atol 1e-4 (both sides score in f32;
only the accumulation order differs). bf16 stores the same: the query is
cast to bf16 on both sides, bf16 x bf16 products are exact in f32, and the
sums accumulate in f32, so again only the order differs.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops import distances as jax_distances
from image_search_engine_tpu.ops.topk_pallas import _select_topt
from image_search_engine_tpu.ops.topk_pallas import topk_twophase as jax_topk_twophase
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.ops.distances import topk_flat
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make_store(rng, n, d, kind, metric):
    """(x f32, norms or None, pad-row mask) for a plain, pad-row or tie-heavy store."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    pad = np.zeros(n, bool)
    if kind == "ties":  # every row repeated ~4 times: distance ties everywhere
        x = x[rng.integers(0, n // 4, n)]
    norms = None
    if kind == "pad":  # PAD_NORM rows inside the store, at the origin
        pad[rng.choice(n, n // 10, replace=False)] = True
        x *= 10
        if metric == "ip":
            x = -np.abs(x)  # real rows score below the zero pad rows
        x[pad] = 0.0
        norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
        norms[pad] = PAD_NORM
    return x, norms, pad


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


# n, d, Q, k, store dtype, metric, store kind. N = 1000 is one JAX tile
# of 8 groups (the select runs at k = 1, not at k = 10); N = 5000 with
# tile_n = 1024 spans several tiles (40 groups on both sides).
JAX_CASES = [
    (1000, 16, 5, 1, "f32", "l2", "plain"),
    (1000, 130, 1, 10, "bf16", "ip", "plain"),
    (5000, 16, 1, 10, "f32", "ip", "plain"),
    (5000, 130, 5, 1, "bf16", "l2", "plain"),
    (1000, 16, 5, 1, "f32", "l2", "pad"),
    (5000, 16, 5, 10, "bf16", "ip", "pad"),
    (5000, 130, 1, 10, "f32", "l2", "ties"),
    (1000, 16, 5, 1, "bf16", "ip", "ties"),
]


@pytest.mark.parametrize("n,d,nq,k,dtype,metric,kind", JAX_CASES)
def test_topk_twophase_matches_jax(n, d, nq, k, dtype, metric, kind):
    rng = np.random.default_rng(n + d + nq + k)
    x, norms, pad = make_store(rng, n, d, kind, metric)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    if kind == "pad":
        q *= 1e-2  # near the origin, where the poisoned zero rows sit
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]

    pd, pi, pc = T.topk_twophase(
        torch.from_numpy(q), torch.from_numpy(x).to(tdt), k, metric,
        x_norms=None if norms is None else torch.from_numpy(norms), with_certificate=True)
    jd, ji, jc = jax_topk_twophase(
        jnp.asarray(q), jnp.asarray(x, jdt), k, metric,
        x_norms=None if norms is None else jnp.asarray(norms), tile_n=1024,
        with_certificate=True, interpret=True)

    assert_topk_match(pd.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pc.all()
    assert not pad[pi.numpy()].any()


@pytest.mark.parametrize("ties", [False, True])
def test_select_topt_matches_jax_kernel(ties):
    # the same (group-major for JAX, query-major here) mins into both
    # selects: values and ids must agree exactly, ties included
    rng = np.random.default_rng(7)
    mins = (rng.integers(0, 6, (5, 40)) if ties else rng.standard_normal((5, 40))).astype(np.float32)
    jv, ji = _select_topt(jnp.asarray(mins.T), 12, interpret=True)
    pv, pi = T.select_topt(torch.from_numpy(mins), 12)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv)[:, :5].T)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji)[:, :5].T)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_topk_flat_oracle_matches_jax(metric):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((300, 24)).astype(np.float32)
    q = rng.standard_normal((4, 24)).astype(np.float32)
    pd, pi = topk_flat(torch.from_numpy(q), torch.from_numpy(x), 7, metric)
    jd, ji = jax_distances.topk_flat(jnp.asarray(q), jnp.asarray(x), 7, metric)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))


def _oracle(q, q_cross, x, k, metric):
    """float64 top-k; ``q_cross`` is the query as the cross term sees it."""
    q64, qc, x64 = (a.astype(np.float64) for a in (q, q_cross, x))
    if metric == "l2":
        s = (q64 ** 2).sum(1)[:, None] - 2 * qc @ x64.T + (x64 ** 2).sum(1)[None]
        idx = np.argsort(s, axis=1, kind="stable")[:, :k]
    else:
        s = qc @ x64.T
        idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, 1), idx


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,d", [(200, 16), (1000, 130), (5003, 16)])
@pytest.mark.parametrize("nq,k", [(1, 1), (5, 10)])
def test_topk_twophase_matches_f64_oracle(metric, dtype, n, d, nq, k):
    # wider coverage than the interpret-mode cases: N = 200 has 2 groups
    # (t >= ngroups, no select), N = 5003 a ragged last group
    rng = np.random.default_rng(n * 7 + d + nq)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    xs = torch.from_numpy(x).to(tdt)
    pd, pi, pc = T.topk_twophase(torch.from_numpy(q), xs, k, metric, with_certificate=True)
    # the oracle scores what the port scores: the store's own values
    # (cosine: normalized in f32, rounded again), the query rounded to the
    # store dtype in the cross term, and the f32 query's norm for l2
    rnd = lambda a: torch.from_numpy(a).to(tdt).float().numpy()  # noqa: E731
    x = xs.float().numpy()
    if metric == "cosine":
        x = rnd(x / np.linalg.norm(x, axis=1, keepdims=True))
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    od, oi = _oracle(q, rnd(q), x, k, "ip" if metric == "cosine" else metric)
    assert pc.all()
    assert_topk_match(pd.numpy(), pi.numpy(), od, oi, rtol=1e-4, atol=1e-3)


def test_topk_twophase_safe_escalates(monkeypatch, caplog):
    """A certificate failure at the fast margin re-runs once at the wide
    margin and logs; the result is the wide run's. The failure is forced
    so the test does not depend on the CPU's accumulation order."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3000, 32)).astype(np.float32))
    real = T.topk_twophase
    margins = []

    def fails_at_margin_0(*a, t_margin=4, **kw):
        margins.append(t_margin)
        d, i, cert = real(*a, t_margin=t_margin, **kw)
        return (d, i, torch.zeros_like(cert)) if t_margin == 0 else (d, i, cert)

    monkeypatch.setattr(T, "topk_twophase", fails_at_margin_0)
    with caplog.at_level(logging.WARNING):
        sd, si = T.topk_twophase_safe(q, x, 10, "l2", t_margin=0, wide_margin=40)
    assert margins == [0, 40]
    assert "re-running at margin 40" in caplog.text
    wd, wi = real(q, x, 10, "l2", t_margin=40)
    np.testing.assert_array_equal(si.numpy(), wi.numpy())
    np.testing.assert_array_equal(sd.numpy(), wd.numpy())


def test_certificate_trips_on_adversarial_boundary():
    """The JAX package's adversarial corpus (rows ~ 2 q0, so scores cancel
    to a few ulps): the plain path's phase-1 and phase-2 accumulation
    orders differ, margin 0 loses neighbours, and every query the
    certificate passes agrees with the wide-margin rescan."""
    rng = np.random.default_rng(0)
    d, n = 512, 64 * 128
    q = rng.standard_normal((4, d)).astype(np.float32) * 10
    dirs = rng.standard_normal((n, d)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    x = (2 * q[0] + 1e-4 * dirs * np.abs(q[0]).mean()).astype(np.float32)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    dd, ii, cert = T.topk_twophase(qt, xt, 10, "l2", t_margin=0, with_certificate=True)
    wd, wi = T.topk_twophase(qt, xt, 10, "l2", t_margin=40)
    for r in range(4):
        if cert[r]:
            np.testing.assert_allclose(np.sort(dd[r].numpy()), np.sort(wd[r].numpy()),
                                       rtol=1e-6, atol=0.0)


def test_kernel_wrappers_use_plain_versions_on_cpu():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((3, 24)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((700, 24)).astype(np.float32))
    norms = (x * x).sum(1)
    T.reset_launch_counts()
    mins = T.groupmin(q, x, norms)
    vals, cand = T.select_topt(mins, 4)
    scores = T.rescore(q, x, norms, cand)
    assert T.launch_counts() == {"groupmin": 0, "select_topt": 0, "rescore": 0,
                                 "groupmin_q8": 0, "rescore_q8": 0, "topk_running": 0}
    assert mins.shape == (3, 6) and scores.shape == (3, 4 * 128)
    np.testing.assert_array_equal(mins.numpy(), T.groupmin_ref(q, x, norms).numpy())
    # the ragged last group (700 = 5*128 + 60) scores +inf past row 699
    assert torch.isinf(T.rescore(q, x, norms, torch.full((3, 1), 5, dtype=torch.int32))[:, 60:]).all()
    with pytest.raises(ValueError):
        T.groupmin(q.to(torch.bfloat16), x, norms)  # query not cast to the store dtype

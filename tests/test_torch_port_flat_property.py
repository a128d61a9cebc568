"""Property test of the port's FlatIndex over every store dtype: store
{f32, bf16, int8} x metric {l2, ip} x data {random rows, duplicated rows
(exact ties), N = 128 g - 1 and 128 g + 1 (a ragged last group and the
store's pad rows at the group boundary)}, against a float64 oracle over
the store's own values.

The oracle scores what the search scores: the store values (bf16-rounded
or dequantized), the query as the cross term sees it (cast to bf16, or
round-tripped through the per-row int8 quantization) and, for l2, the f32
query's own squared norm. Tolerance rtol 1e-4 / atol 1e-3 (f32 sums and
epilogues against float64); ids equal where distances are distinct, id
sets equal apart from ties at the k-th; every certificate True.
"""

import numpy as np
import pytest
import torch

from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.ops import topk as T

RTOL, ATOL = 1e-4, 1e-3
K = 10


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _store_and_queries(data, seed):
    rng = np.random.default_rng(seed)
    n = {"random": 1000, "ties": 1000, "pad-1": 8 * 128 - 1, "pad+1": 8 * 128 + 1}[data]
    x = rng.standard_normal((n, 24)).astype(np.float32)
    if data == "ties":  # every row repeated ~4 times: exact distance ties
        x = x[rng.integers(0, n // 4, n)]
    return x, rng.standard_normal((5, 24)).astype(np.float32)


def _query_as_scored(q, dtype):
    if dtype == "bf16":
        return torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    if dtype == "int8":
        codes, sq = T.quantize_int8(torch.from_numpy(q))
        return (codes.double() * sq.double()[:, None]).numpy()
    return q.astype(np.float64)


@pytest.mark.parametrize("data", ["random", "ties", "pad-1", "pad+1"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_flat_index_matches_f64_oracle(dtype, metric, data):
    x, q = _store_and_queries(data, seed=len(data) + 7 * len(dtype))
    index = FlatIndex(metric, dtype=dtype, device="cpu").add(x)
    store = index.store
    assert (store.n_padded > store.n) == data.startswith("pad")  # PAD_NORM rows in the store
    xs = store.values().double().numpy()
    qc = _query_as_scored(q, dtype)
    if metric == "l2":
        q64 = q.astype(np.float64)
        s = (q64 ** 2).sum(1)[:, None] - 2 * qc @ xs.T + (xs ** 2).sum(1)[None]
        order = np.argsort(s, axis=1, kind="stable")[:, :K]
    else:
        s = qc @ xs.T
        order = np.argsort(-s, axis=1, kind="stable")[:, :K]
    od, oi = np.take_along_axis(s, order, 1), order

    pd, pi = index.search(q, K)
    _, ci, cert = T.topk_twophase(torch.from_numpy(q), store.vectors, K, metric,
                                  x_norms=store.norms, x_scale=store.scales,
                                  with_certificate=True)
    assert cert.all()
    np.testing.assert_array_equal(ci.numpy(), pi)
    assert (pi < store.n).all()  # never a pad row
    np.testing.assert_allclose(pd, od, rtol=RTOL, atol=ATOL)
    for r in range(od.shape[0]):
        tol = ATOL + RTOL * np.abs(od[r])
        gap = np.abs(np.diff(od[r])) > tol[1:]
        kth = od[r][-1]  # the k-th may tie with rows past it: left to the set check
        distinct = (np.concatenate([[True], gap]) & np.concatenate([gap, [True]])
                    & (np.abs(od[r] - kth) > tol))
        np.testing.assert_array_equal(pi[r][distinct], oi[r][distinct])
        assert (set(pi[r][np.abs(pd[r] - kth) > tol].tolist())
                == set(oi[r][np.abs(od[r] - kth) > tol].tolist()))

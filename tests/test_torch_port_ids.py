"""The id dtype of every index type's search, port against the JAX package.

The JAX package's ``FlatIndex.search``, ``IVFIndex.search`` and
``IVFPQIndex.search`` return int32 ids, and so does the port's on every
path: f32, bf16 and int8 stores; l2, ip, cosine and chi2; k <= 128 (the
two-phase search), k > 128 (the full scan) and k > ntotal (Faiss's -1
tail). Inputs: ``np.random.default_rng(0)``, 300 x 33 f32 rows, the first
three rows as queries. The ids themselves agree where both packages score
alike (f32 stores); the engine's flat family gives the same ids as
``FlatIndex.search``.
"""

import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from image_search_engine_tpu.index.ivf import IVFIndex as JaxIVFIndex
from image_search_engine_tpu.index.ivf import IVFPQIndex as JaxIVFPQIndex
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex
from image_search_engine_tpu_torch.serving import fused

N, D, KS = 300, 33, (5, 200, 400)  # k <= 128, k > 128, k > ntotal


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def data():
    x = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)
    return x, x[:3]


@pytest.mark.parametrize("dtype,metric", [
    ("f32", "l2"), ("f32", "ip"), ("f32", "cosine"), ("f32", "chi2"),
    ("bf16", "l2"), ("bf16", "ip"), ("bf16", "cosine"),
    ("int8", "l2"), ("int8", "ip"), ("int8", "cosine"),
])
def test_flat_ids_are_int32_like_the_jax_package(data, dtype, metric):
    x, q = data
    port = FlatIndex(metric, dtype=dtype, device="cpu").add(x)
    ref = JaxFlatIndex(metric, dtype=dtype).add(x)
    for k in KS:
        _, pi = port.search(q, k)
        _, ji = ref.search(q, k)
        assert pi.dtype == ji.dtype == np.int32, (k, pi.dtype, ji.dtype)
        assert pi.shape == ji.shape == (3, k)
        np.testing.assert_array_equal(pi < 0, ji < 0)  # the same Faiss tail
        if dtype == "f32":
            np.testing.assert_array_equal(pi, ji)


@pytest.mark.parametrize("kind", ["ivf", "ivfpq"])
def test_ivf_ids_are_int32_like_the_jax_package(data, kind):
    x, q = data
    if kind == "ivf":
        port, ref = IVFIndex("l2", nlist=4, nprobe=2, device="cpu"), JaxIVFIndex("l2", nlist=4,
                                                                                 nprobe=2)
    else:
        port = IVFPQIndex("l2", nlist=4, nprobe=2, m=3, device="cpu")
        ref = JaxIVFPQIndex("l2", nlist=4, nprobe=2, m=3)
    port.add(x)
    ref.add(x)
    for k in (5, 400):
        _, pi = port.search(q, k)
        _, ji = ref.search(q, k)
        assert pi.dtype == ji.dtype == np.int32, (kind, k, pi.dtype, ji.dtype)
        assert pi.shape == ji.shape == (3, k)


@pytest.mark.parametrize("dtype,metric,k", [("f32", "l2", 5), ("int8", "ip", 5),
                                            ("f32", "chi2", 5), ("bf16", "cosine", 200)])
def test_flat_family_gives_the_ids_of_flat_search(data, dtype, metric, k):
    """The engine's dispatch (serving/fused.flat_family) and
    FlatIndex.search return the same ids, whatever their dtype."""
    x, q = data
    index = FlatIndex(metric, dtype=dtype, device="cpu").add(x)
    core, statics_fn, epilogue = fused.flat_family(index)
    emb = torch.as_tensor(q)
    if metric == "cosine":
        emb = torch.nn.functional.normalize(emb, dim=1)
    kk = statics_fn(k)
    _, fi = epilogue(core(emb, kk, None), k, lambda t_margin=None: core(emb, kk, t_margin))
    _, si = index.search(q, k)
    np.testing.assert_array_equal(np.asarray(fi, np.int64), si.astype(np.int64))

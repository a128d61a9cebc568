"""The sharded flat search on an 8-shard CPU mesh: ``distributed_topk``
against the JAX package's on its 8-device virtual mesh (``use_pallas=False``),
and ``FlatIndex(mesh=)`` against the port's unsharded ``FlatIndex``.

203 rows (not a multiple of 8: 5 pad rows), so a shard holds 26 rows, fewer
than k = 40. Ids are equal (the random data has no ties); distances are
held to rtol 1e-5 / atol 1e-4 against the JAX package (f32 products summed
in another order; l2 adds the query norm to a cancelling difference) and
bit for bit against the port's unsharded search, which scores each row the
same way. The JAX search runs under ``jax.jit`` (one compile a case).
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.store import VectorStore as JaxVectorStore
from image_search_engine_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_search_engine_tpu.parallel.topk import distributed_topk as jax_distributed_topk
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.index.store import VectorStore
from image_search_engine_tpu_torch.parallel import topk as port_ptopk
from image_search_engine_tpu_torch.parallel.mesh import Mesh, replicate, shard_rows
from image_search_engine_tpu_torch.parallel.topk import distributed_topk
from image_search_engine_tpu_torch.serving import fused

MESH = Mesh(["cpu"] * 8)
CASES = [(dt, m) for dt in ("f32", "bf16", "int8") for m in ("l2", "ip", "cosine")]
CASES.append(("f32", "chi2"))


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def data(metric: str, n: int = 203, d: int = 24, nq: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    if metric == "chi2":
        x, q = np.abs(x), np.abs(q)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return x, q


@pytest.mark.parametrize("dtype,metric", CASES)
def test_distributed_topk_matches_the_jax_package(dtype, metric):
    """Both packages' stores built from the same rows on their 8-shard
    meshes, k = 40 (past a shard's 26 rows); the port's plain scan against
    the JAX package's XLA path, and so are the plain versions of the port's
    kernels, except over a bf16 store, where they score the query rounded
    to bf16 as the TPU kernels do (held against the unsharded port below).
    Cosine is ip over normalized rows."""
    k = 40
    x, q = data(metric)
    search = "ip" if metric == "cosine" else metric
    jmesh = jax_make_mesh(8)
    js = JaxVectorStore.build(x, mesh=jmesh, dtype=dtype)
    jax_search = jax.jit(functools.partial(
        jax_distributed_topk, k=k, metric=search, mesh=jmesh, use_pallas=False,
        with_certificate=True))
    jd, ji, jc = jax.device_get(jax_search(jnp.asarray(q), js.vectors, js.norms,
                                           scales_sharded=js.scales))
    ps = VectorStore.build(x, dtype=dtype, device="cpu", mesh=MESH)
    assert ps.n_padded == js.n_padded == 208 and len(ps.vectors) == 8
    for use_kernels in (False,) if dtype == "bf16" else (False, True):
        pd, pi, pc = distributed_topk(torch.from_numpy(q), ps.vectors, ps.norms, k, search,
                                      MESH, use_kernels=use_kernels, scales_shards=ps.scales,
                                      with_certificate=True)
        assert pi.dtype == torch.int32 and pi.shape == (3, k)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
        np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-4)
        assert pc.all() and np.asarray(jc).all()


@pytest.mark.parametrize("shards", [1, 3, 8, 64])
@pytest.mark.parametrize("dtype,metric", CASES)
def test_sharded_flat_index_gives_the_unsharded_answer(dtype, metric, shards):
    """Any shard count (64 shards: more shards than row blocks of 8, most
    of them padding) and k past the rows (the Faiss (-1, worst) tail)."""
    x, q = data(metric)
    one = FlatIndex(metric, dtype, device="cpu").add(x)
    sharded = FlatIndex(metric, dtype, mesh=Mesh(["cpu"] * shards)).add(x)
    for k in (1, 7, 150, 250):
        d1, i1 = one.search(q, k)
        d2, i2 = sharded.search(q, k)
        assert i2.dtype == np.int32
        np.testing.assert_array_equal(i2, i1)
        np.testing.assert_array_equal(d2, d1)


def test_sharded_index_saves_and_loads_across_meshes(tmp_path):
    x, q = data("l2")
    for dtype in ("f32", "bf16", "int8"):
        path = tmp_path / f"{dtype}.npz"
        FlatIndex("l2", dtype, mesh=MESH).add(x).save(path)
        loaded = FlatIndex.load(path, mesh=Mesh(["cpu"] * 3))
        ref = FlatIndex.load(path, device="cpu")
        assert loaded.store.n_padded == 216 and loaded.ntotal == 203  # lcm(8, 3) = 24
        np.testing.assert_array_equal(loaded.search(q, 9)[1], ref.search(q, 9)[1])
        np.testing.assert_array_equal(loaded.store.to_host(), ref.store.to_host())


def test_a_second_add_rebuilds_the_sharded_store():
    x, q = data("l2")
    sharded = FlatIndex("l2", mesh=MESH).add(x[:100]).add(x[100:])
    one = FlatIndex("l2", device="cpu").add(x)
    np.testing.assert_array_equal(sharded.search(q, 6)[1], one.search(q, 6)[1])


def test_certificate_failure_retries_at_the_wide_margin(monkeypatch, caplog):
    """A failed certificate on any shard re-runs the whole search at margin
    32; a failure there too is logged as an error, as the JAX package's."""
    x, q = data("l2")
    index = FlatIndex("l2", mesh=MESH).add(x)
    margins = []
    real = port_ptopk.local_topk_with_norms

    def flaky(*a, t_margin=None, **kw):
        margins.append(t_margin)
        d, i, cert = real(*a, t_margin=t_margin, **kw)
        return d, i, cert & (t_margin is not None)

    monkeypatch.setattr(port_ptopk, "local_topk_with_norms", flaky)
    _, got = index.search(q, 5)
    assert margins == [None] * 8 + [32] * 8
    np.testing.assert_array_equal(got, FlatIndex("l2", device="cpu").add(x).search(q, 5)[1])
    margins.clear()
    monkeypatch.setattr(port_ptopk, "local_topk_with_norms",
                        lambda *a, **kw: (*real(*a, **kw)[:2], torch.zeros(3, dtype=torch.bool)))
    with caplog.at_level(logging.ERROR):
        index.search(q, 5)
    assert "still failing after wide-margin (32) escalation on 3/3 queries" in caplog.text


@pytest.mark.parametrize("dtype,metric", [("f32", "l2"), ("int8", "ip"), ("bf16", "cosine"),
                                          ("f32", "chi2")])
def test_the_served_flat_family_on_a_mesh_gives_the_search_ids(dtype, metric):
    """serving/fused.flat_family on a mesh (this process's merge; one
    process, so no cross-process stage) returns FlatIndex.search's ids."""
    x, q = data(metric)
    index = FlatIndex(metric, dtype, mesh=MESH).add(x)
    core, statics_fn, epilogue = fused.flat_family(index)
    assert fused.across_processes(index) is None
    emb = torch.from_numpy(q)
    for k in (5, 200):
        kk = statics_fn(k)
        _, fi = epilogue(core(emb, kk, None), k, lambda t_margin=None: core(emb, kk, t_margin))
        np.testing.assert_array_equal(fi, index.search(q, k)[1])


def test_shard_rows_and_replicate():
    x = torch.arange(20.0).reshape(10, 2)
    blocks = shard_rows(x, Mesh(["cpu"] * 5))
    assert [b.data_ptr() for b in blocks] == [x[2 * i].data_ptr() for i in range(5)]  # views
    padded = shard_rows(x, Mesh(["cpu"] * 3), rows_per_shard=4, fill=-1.0)
    assert [tuple(b.shape) for b in padded] == [(4, 2)] * 3
    assert (padded[2][2:] == -1).all() and torch.equal(padded[2][:2], x[8:])
    with pytest.raises(ValueError, match="pad first"):
        shard_rows(x, Mesh(["cpu"] * 3))
    assert all(t is x for t in replicate(x, Mesh(["cpu"] * 2)))

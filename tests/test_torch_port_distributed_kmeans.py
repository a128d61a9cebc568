"""``parallel/kmeans.py`` on an 8-shard CPU mesh against the JAX package's
``lloyd_sharded`` on its 8-device virtual mesh, and against the port's own
unsharded trainer. The same seeded numpy inputs go through both.

Tolerances: the sums add in another order in each (per-shard partial sums
over 8 shards against a one-hot product, or against one segment sum), so
centroids are held to rtol 1e-4 / atol 1e-5; the inertia sums f32
distances computed as ||c||^2 - 2 x.c + ||x||^2, which cancel, so an ulp
of the centroids moves it by more: rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from image_search_engine_tpu.parallel.kmeans import lloyd_sharded as jax_lloyd_sharded
from image_search_engine_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_search_engine_tpu_torch.ops.kmeans import kmeans_fit, lloyd
from image_search_engine_tpu_torch.parallel.kmeans import kmeans_fit_sharded, lloyd_sharded
from image_search_engine_tpu_torch.parallel.mesh import Mesh, shard_rows

MESH = Mesh(["cpu"] * 8)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def padded(x: np.ndarray, s: int = 8):
    """(points, weights) padded with zero-weight rows to a multiple of s."""
    npad = -(-x.shape[0] // s) * s
    xp = np.zeros((npad, x.shape[1]), np.float32)
    xp[: x.shape[0]] = x
    w = np.zeros(npad, np.float32)
    w[: x.shape[0]] = 1.0
    return xp, w


@pytest.mark.parametrize("spherical", [False, True])
def test_lloyd_sharded_matches_the_jax_package(spherical):
    """203 rows over 8 shards (5 zero-weight pad rows), one init."""
    rng = np.random.default_rng(3)
    n, d, k = 203, 12, 6
    x = rng.standard_normal((n, d)).astype(np.float32)
    if spherical:
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    init = x[rng.choice(n, k, replace=False)]
    xp, w = padded(x)
    jmesh = jax_make_mesh(8)
    jc, ji = jax_lloyd_sharded(
        jax.device_put(jnp.asarray(xp), NamedSharding(jmesh, P("data", None))),
        jax.device_put(jnp.asarray(w), NamedSharding(jmesh, P("data"))),
        jnp.asarray(init), k, jmesh, niter=8, spherical=spherical)
    pc, pi = lloyd_sharded(shard_rows(torch.from_numpy(xp), MESH),
                           shard_rows(torch.from_numpy(w), MESH),
                           torch.from_numpy(init), k, MESH, niter=8, spherical=spherical)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(pi), float(ji), rtol=1e-4)


def test_lloyd_sharded_matches_the_unsharded_lloyd():
    """The port against itself: the pad rows (weight 0) move nothing."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((301, 8)).astype(np.float32)
    init = torch.from_numpy(x[rng.choice(301, 7, replace=False)])
    xp, w = padded(x)
    c1, i1 = lloyd(torch.from_numpy(x), init, 7, niter=10)
    c2, i2 = lloyd_sharded(shard_rows(torch.from_numpy(xp), MESH),
                           shard_rows(torch.from_numpy(w), MESH), init, 7, MESH, niter=10)
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(i2), float(i1), rtol=1e-4)


@pytest.mark.parametrize("spherical", [False, True])
def test_kmeans_fit_sharded_starts_where_kmeans_fit_does(spherical):
    """The restarts draw the unsharded trainer's inits (one generator from
    the seed on the home device), so both runs end at the same codebook."""
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 4
    x = np.concatenate([c + 0.05 * rng.standard_normal((50, 8)).astype(np.float32)
                        for c in centers])[:203]
    c1, i1 = kmeans_fit(torch.from_numpy(x), 4, niter=12, nredo=2, seed=0, spherical=spherical)
    c2, i2 = kmeans_fit_sharded(x, 4, MESH, niter=12, nredo=2, seed=0, spherical=spherical)
    np.testing.assert_allclose(c2.numpy(), c1.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(i2), float(i1), rtol=1e-4)
    if spherical:
        np.testing.assert_allclose(np.linalg.norm(c2.numpy(), axis=1), 1.0, rtol=1e-5)
    else:  # the blobs are found
        dist = ((centers[:, None, :] - c2.numpy()[None]) ** 2).sum(-1)
        assert (dist.min(1) < 0.1).all()


def test_empty_cluster_keeps_its_centroid():
    x = np.zeros((16, 4), np.float32)
    x[8:] = 1.0
    init = torch.tensor([[0.0] * 4, [1.0] * 4, [50.0] * 4])  # the third gets no point
    xp, w = padded(x)
    c, inertia = lloyd_sharded(shard_rows(torch.from_numpy(xp), MESH),
                               shard_rows(torch.from_numpy(w), MESH), init, 3, MESH, niter=3)
    np.testing.assert_array_equal(c.numpy(), init.numpy())
    assert float(inertia) == 0.0

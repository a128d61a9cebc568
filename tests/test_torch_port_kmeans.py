"""The port's k-means (image_search_engine_tpu_torch/ops/kmeans.py) against
the JAX package's (ops/kmeans.py, and the Pallas assignment kernel of
ops/kmeans_pallas.py in interpret mode) on the same numpy-seeded inputs.

On the CPU ``assign`` runs its plain version; the CUDA kernel is compared
with that plain version on the card by ``chip_smoke.py``.

Tolerances: assignment distances rtol 1e-5 / atol 1e-4 (both score in f32;
only the summation order differs); Lloyd centroids atol 1e-4 after 10
iterations on well-separated clusters (identical assignments, so only the
summation order of the cluster sums differs); PQ quantization MSE within 5%
of the JAX package's (the inits differ: torch.Generator vs jax.random).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops import kmeans as jax_kmeans
from image_search_engine_tpu.ops.kmeans_pallas import assign_pallas
from image_search_engine_tpu_torch.ops import kmeans as K

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def blobs(rng, n, d, k, spread=6.0):
    """n points around k well-separated centres: (points, centres)."""
    cent = (rng.standard_normal((k, d)) * spread).astype(np.float32)
    return (cent[rng.integers(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32), cent


@pytest.mark.parametrize("n,d,k", [(300, 20, 13), (257, 64, 8), (64, 3, 70)])
def test_assign_matches_jax_and_pallas(n, d, k):
    rng = np.random.default_rng(n + d + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    codes, dists = K.assign(torch.from_numpy(x), torch.from_numpy(c))
    assert codes.dtype == torch.int32 and codes.shape == dists.shape == (n,)
    for ref in (jax_kmeans.assign_jax(jnp.asarray(x), jnp.asarray(c)),
                assign_pallas(jnp.asarray(x), jnp.asarray(c), interpret=True)):
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(dists.numpy(), np.asarray(ref[1]), rtol=RTOL, atol=ATOL)


def test_assign_batched_is_per_problem():
    """(B, N, d) against (B, K, d), also on the strided (m, N, dsub) view
    of (N, m, dsub) residuals: each batch row is its own problem."""
    rng = np.random.default_rng(1)
    resid = rng.standard_normal((200, 4, 16)).astype(np.float32)
    books = rng.standard_normal((4, 11, 16)).astype(np.float32)
    view = torch.from_numpy(resid).transpose(0, 1)
    assert not view.is_contiguous()
    codes, dists = K.assign(view, torch.from_numpy(books))
    assert codes.shape == (4, 200)
    for b in range(4):
        jc, jd = jax_kmeans.assign_jax(jnp.asarray(resid[:, b]), jnp.asarray(books[b]))
        np.testing.assert_array_equal(codes[b].numpy(), np.asarray(jc))
        np.testing.assert_allclose(dists[b].numpy(), np.asarray(jd), rtol=RTOL, atol=ATOL)


def test_assign_ties_go_to_the_lowest_centroid():
    rng = np.random.default_rng(2)
    c = rng.standard_normal((5, 8)).astype(np.float32)
    c = np.concatenate([c, c[[3, 1]]])  # centroids 5 and 6 duplicate 3 and 1
    x = np.concatenate([c, rng.standard_normal((50, 8)).astype(np.float32)])
    codes, _ = K.assign(torch.from_numpy(x), torch.from_numpy(c))
    jc, _ = jax_kmeans.assign_jax(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    assert not np.isin(codes.numpy(), [5, 6]).any()


def test_cpu_tensors_never_launch_the_kernel():
    K.assign.launches = 0
    K.assign(torch.randn(10, 4), torch.randn(3, 4))
    assert K.assign.launches == 0


@pytest.mark.parametrize("spherical", [False, True])
def test_lloyd_from_jax_init_matches_jax(spherical):
    rng = np.random.default_rng(3)
    x, _ = blobs(rng, 1200, 24, 6)
    init = x[rng.choice(len(x), 6, replace=False)]
    if spherical:
        x = x / np.linalg.norm(x, axis=1, keepdims=True)
        init = init / np.linalg.norm(init, axis=1, keepdims=True)
    jc, ji = jax_kmeans.lloyd(jnp.asarray(x), jnp.asarray(init), 6, niter=10,
                              spherical=spherical)
    pc, pi = K.lloyd(torch.from_numpy(x), torch.from_numpy(init), 6, niter=10,
                     spherical=spherical)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(float(pi), float(ji), rtol=1e-4)


def test_update_keeps_empty_clusters():
    x = torch.tensor([[0.0, 0.0], [2.0, 2.0], [10.0, 10.0]])
    prev = torch.tensor([[1.0, 1.0], [5.0, 5.0], [-3.0, 7.0]])
    new, counts = K._update(x, torch.tensor([0, 0, 1], dtype=torch.int32), 3, prev)
    np.testing.assert_allclose(new.numpy(), [[1, 1], [10, 10], [-3, 7]])
    np.testing.assert_array_equal(counts.numpy(), [2, 1, 0])


def test_kmeans_fit_keeps_the_best_restart_and_is_seeded():
    rng = np.random.default_rng(4)
    x, cent = blobs(rng, 900, 16, 5)
    km = K.KMeans(n_clusters=5, niter=15, nredo=3, seed=7, spherical=False,
                  device="cpu").fit(x)
    again = K.KMeans(n_clusters=5, niter=15, nredo=3, seed=7, spherical=False,
                     device="cpu").fit(x)
    np.testing.assert_array_equal(km.cluster_centers_, again.cluster_centers_)
    inertias = []
    gen = torch.Generator().manual_seed(7)
    for _ in range(3):  # the restarts fit draws, from the same generator
        init = torch.from_numpy(x)[K._random_rows(len(x), 5, gen, "cpu")]
        inertias.append(float(K.lloyd(torch.from_numpy(x), init, 5, niter=15)[1]))
    assert km.inertia_ == pytest.approx(min(inertias), rel=1e-9)
    # well separated: every true centre has a fitted centroid within noise
    gap = np.linalg.norm(cent[:, None] - km.cluster_centers_[None], axis=2).min(1)
    assert gap.max() < 1.0
    codes = km.transform(x)
    assert codes.shape == (900, 1)
    jc, _ = jax_kmeans.assign_jax(jnp.asarray(x), jnp.asarray(km.cluster_centers_))
    np.testing.assert_array_equal(codes[:, 0], np.asarray(jc))


def test_kmeans_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        K.KMeans(n_clusters=4)
    assert K.KMeans(n_clusters=4, device="cpu").device == torch.device("cpu")


def test_subspace_kmeans_codes_are_nearest_and_mse_matches_jax():
    rng = np.random.default_rng(5)
    n, m, dsub, k = 1500, 4, 8, 32
    resid = rng.standard_normal((n, m, dsub)).astype(np.float32)
    books, codes = K.subspace_kmeans(torch.from_numpy(resid), k=k, niter=12, seed=3, chunk=512)
    books, codes = books.numpy(), codes.numpy()
    assert books.shape == (m, k, dsub) and codes.shape == (n, m) and codes.dtype == np.int32
    d2 = ((resid.transpose(1, 0, 2)[:, :, None] - books[:, None]) ** 2).sum(-1)  # (m, n, k)
    best = d2.min(-1)
    chosen = np.take_along_axis(d2, codes.T[:, :, None], 2)[..., 0]
    np.testing.assert_allclose(chosen, best, rtol=1e-5, atol=1e-5)
    mse = chosen.sum() / n
    jb, jc = jax_kmeans.subspace_kmeans(jnp.asarray(resid), k=k, niter=12, seed=3)
    jb, jc = np.asarray(jb), np.asarray(jc)
    j_rec = np.stack([jb[b][jc[:, b]] for b in range(m)], axis=1)
    jax_mse = ((resid - j_rec) ** 2).sum() / n
    assert abs(mse - jax_mse) <= 0.05 * jax_mse, (mse, jax_mse)

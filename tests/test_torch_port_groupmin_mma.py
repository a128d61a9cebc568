"""The bf16 tensor-core phase 1 and phase 2 of the port's flat search
(image_search_engine_tpu_torch/ops/topk.py ``groupmin``, ``rescore``;
``csrc/groupmin_mma.cuh`` ``groupmin_mma_kernel``, ``csrc/topk_twophase.cu``
``rescore_mma_kernel``; ``csrc/mma.cuh``).

The kernels run only on the card, where ``chip_smoke.py`` holds them to
their plain versions. Here:

  (a) the tile plan both wrappers launch with (``mma_plan``): padded d, the
      k-chunk, shared memory within the budget, every grid dimension within
      CUDA's limits, and the phase-1 grid covering every (query, group) pair
      exactly once, as the kernel maps its block index;
  (b) the routing, with a fake kernel library and ``_on_cuda`` patched: a
      bf16 store calls the tensor-core entry points on one plan, an f32 store
      of up to ``F32_CUDA_CORE_MAX_Q`` queries the CUDA-core ones, and a
      non-zero return code raises;
  (c) the port's bf16 ``topk_twophase`` on the CPU (each kernel's plain
      version) against the JAX package's ``topk_twophase`` in interpret mode
      at d = 130 (rows of no 16-byte multiple), Q = 17 (a partial 16-query
      tile on the card), N = 129 (every group rescored) and 5000. Tolerance
      rtol 1e-5 / atol 1e-4: both sides multiply the bf16-cast query with
      the bf16 store exactly in f32 and sum in f32, only in another order.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops.topk_pallas import topk_twophase as jax_topk_twophase
from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import topk as T

RTOL, ATOL = 1e-5, 1e-4
GRID_MAX = 2 ** 31 - 1
MAX_THREADS = 1024


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# (a) the tile plan
# ---------------------------------------------------------------------------


def assert_covers_once(plan):
    """Every (query, group) pair lies in exactly one phase-1 block: the
    blocks' rectangles counted on the coarse grid of their own edges."""
    q0, q1, g0, g1 = plan.block_tiles(torch.arange(plan.grid))
    assert bool((q0 < q1).all()) and bool((g0 < g1).all())
    assert int(q0.min()) >= 0 and int(q1.max()) <= plan.nq
    assert int(g0.min()) >= 0 and int(g1.max()) <= plan.ngroups
    qb = torch.unique(torch.cat([q0, q1, torch.tensor([0, plan.nq])]))
    gb = torch.unique(torch.cat([g0, g1, torch.tensor([0, plan.ngroups])]))
    assert int(qb[0]) == 0 and int(qb[-1]) == plan.nq
    assert int(gb[0]) == 0 and int(gb[-1]) == plan.ngroups
    iq0, iq1 = torch.searchsorted(qb, q0), torch.searchsorted(qb, q1)
    ig0, ig1 = torch.searchsorted(gb, g0), torch.searchsorted(gb, g1)
    diff = torch.zeros(len(qb) + 1, len(gb) + 1, dtype=torch.int64)
    ones = torch.ones_like(q0)
    for rows, cols, sign in ((iq0, ig0, 1), (iq0, ig1, -1), (iq1, ig0, -1), (iq1, ig1, 1)):
        diff.index_put_((rows, cols), sign * ones, accumulate=True)
    cover = diff.cumsum(0).cumsum(1)[:len(qb) - 1, :len(gb) - 1]
    assert bool((cover == 1).all())


@pytest.mark.parametrize("d", [1, 16, 128, 130, 2048])
@pytest.mark.parametrize("nq", [1, 7, 16, 17, 2048, 4096])
def test_mma_plan(nq, d):
    for n in (1, 127, 128, 129, 10 ** 6):
        p = T.mma_plan(nq, n, d)
        assert (p.nq, p.n, p.d) == (nq, n, d)
        assert p.dp % 16 == 0 and d <= p.dp < d + 16
        assert p.kc % 16 == 0 and 16 <= p.kc <= p.dp
        assert p.rescore_kc % 16 == 0 and 16 <= p.rescore_kc <= p.dp
        assert p.bq in T.MMA_BQ and p.bq >= min(nq, 128)
        assert 1 <= p.gps <= p.ngroups
        assert p.smem <= T._SMEM_BYTES and p.rescore_smem <= T._SMEM_BYTES
        assert 1 <= p.grid <= GRID_MAX
        for t in {1, min(12, p.ngroups), p.ngroups}:
            assert 1 <= p.rescore_grid(t) <= GRID_MAX
        assert T._MMA_WARPS * 32 <= MAX_THREADS and T._RESCORE_MMA_WARPS * 32 <= MAX_THREADS
        assert_covers_once(p)


def test_mma_plan_bench_point():
    # bench.py's point: the widest query tile, resident, whole rows per
    # stage, two blocks per SM
    p = T.mma_plan(2048, 10 ** 6, 128)
    assert (p.bq, p.dp, p.kc, p.resident) == (128, 128, 128, True)
    assert p.smem <= T._MMA_SMEM_TWO_BLOCKS


@pytest.mark.parametrize("nq,resident", [(1, True), (17, True), (32, False), (64, False),
                                         (4096, False)])
def test_mma_plan_streams_the_query_tile_of_wide_rows(nq, resident):
    # 2048-wide rows: a tile stays in shared memory while two blocks still
    # fit an SM, a wider one streams beside the store; either way the tile
    # holds min(Q, 128) queries, so the store is read once per 128 queries
    p = T.mma_plan(nq, 10 ** 6, 2048)
    assert p.resident is resident and p.bq >= min(nq, 128)
    assert p.smem <= T._MMA_SMEM_TWO_BLOCKS


@pytest.mark.parametrize("nq,n,d", [(0, 10, 16), (4, 0, 16), (4, 10, 0), (4, 10, 100_000)])
def test_mma_plan_raises_on_shapes_it_cannot_take(nq, n, d):
    with pytest.raises(ValueError):
        T.mma_plan(nq, n, d)


@pytest.mark.parametrize("d,offset,want", [(128, 0, 8), (130, 0, 2), (129, 0, 1), (128, 1, 1),
                                           (128, 2, 2)])
def test_copy_width(d, offset, want):
    # 16-byte copies need rows of 16-byte multiples at 16-byte aligned
    # addresses, 4-byte copies 4-byte ones; anything else copies element-wise
    buf = torch.zeros(2 * d + 64, dtype=torch.bfloat16)
    assert buf.data_ptr() % 16 == 0
    x = buf[offset:offset + 2 * d].view(2, d)
    q = torch.zeros(1, d, dtype=torch.bfloat16)
    assert T._vec_mma(q, x) == want


# ---------------------------------------------------------------------------
# (b) routing
# ---------------------------------------------------------------------------


class FakeLibrary:
    """Records each entry point's arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    def ise_error_string(self, err):
        return b"fake error"

    def __getattr__(self, name):
        if not name.startswith("ise_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.rc
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """A fake kernel library behind the wrappers, which take CPU tensors for
    CUDA ones."""
    def install(rc=0):
        lib = FakeLibrary(rc)
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        monkeypatch.setattr(T, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(T, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        return lib
    return install


def inputs(dtype, nq=17, n=300, d=130, t=3):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(n, d, generator=g).to(dtype)
    q = torch.randn(nq, d, generator=g).to(dtype)
    norms = (x.float() ** 2).sum(1)
    cand = torch.randint(0, T.num_groups(n), (nq, t), generator=g, dtype=torch.int32)
    return q, x, norms, cand


def test_bf16_routes_to_the_tensor_core_kernels_on_one_plan(fake_cuda):
    lib = fake_cuda()
    q, x, norms, cand = inputs(torch.bfloat16)
    nq, d = q.shape
    n = x.shape[0]
    before = (T.groupmin.launches, T.rescore.launches)
    mins = T.groupmin(q, x, norms)
    scores = T.rescore(q, x, norms, cand)
    assert (T.groupmin.launches, T.rescore.launches) == (before[0] + 1, before[1] + 1)
    assert tuple(mins.shape) == (nq, T.num_groups(n))
    assert tuple(scores.shape) == (nq, cand.shape[1] * T.GROUP)
    assert [c[0] for c in lib.calls] == ["ise_groupmin_mma", "ise_rescore_mma"]
    p = T.mma_plan(nq, n, d)
    gm, rs = lib.calls[0][1], lib.calls[1][1]
    # q, norms, x, out, nq, n, d, bq, dp, kc, gps, resident, smem, vec, stream
    assert gm[4:14] == (nq, n, d, p.bq, p.dp, p.kc, p.gps, int(p.resident), p.smem,
                        T._vec_mma(q, x))
    assert gm[:4] == (q.data_ptr(), norms.data_ptr(), x.data_ptr(), mins.data_ptr())
    # q, norms, x, cand, out, nq, n, d, t, dp, kc, smem, vec, stream
    assert rs[5:13] == (nq, n, d, cand.shape[1], p.dp, p.rescore_kc, p.rescore_smem,
                        T._vec_mma(q, x))
    assert rs[3:5] == (cand.data_ptr(), scores.data_ptr())
    assert gm[8] == rs[9]  # one padded d in both phases
    # d = 130: 260-byte rows take 4-byte copies
    assert T._vec_mma(q, x) == 2


def test_f32_routes_to_the_cuda_core_kernels(fake_cuda):
    # batches up to F32_CUDA_CORE_MAX_Q (larger ones: test_torch_port_groupmin_tf32.py)
    lib = fake_cuda()
    q, x, norms, cand = inputs(torch.float32, nq=T.F32_CUDA_CORE_MAX_Q, d=128)
    T.groupmin(q, x, norms)
    T.rescore(q, x, norms, cand)
    assert [c[0] for c in lib.calls] == ["ise_groupmin", "ise_rescore"]
    gm, rs = lib.calls[0][1], lib.calls[1][1]
    assert gm[4:9] == (q.shape[0], x.shape[0], 128, T._query_tile(q.shape[0], 128 * 4), T._vec(x))
    assert rs[5:10] == (q.shape[0], x.shape[0], 128, cand.shape[1], T._vec(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("which", ["groupmin", "rescore"])
def test_a_failed_launch_raises(fake_cuda, dtype, which):
    fake_cuda(rc=1)
    q, x, norms, cand = inputs(dtype)
    before = getattr(T, which).launches
    with pytest.raises(RuntimeError, match=f"{which} kernel launch failed"):
        if which == "groupmin":
            T.groupmin(q, x, norms)
        else:
            T.rescore(q, x, norms, cand)
    assert getattr(T, which).launches == before


# ---------------------------------------------------------------------------
# (c) the search against the JAX package's
# ---------------------------------------------------------------------------


def assert_topk_match(pd, pi, jd, ji):
    """Distances within tolerance; ids equal where the distances are
    distinct beyond it."""
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)
    for r in range(jd.shape[0]):
        tol = ATOL + RTOL * np.abs(jd[r])
        gap = np.abs(np.diff(jd[r])) > tol[1:]
        distinct = np.ones(jd.shape[1], bool)
        distinct[1:] &= gap
        distinct[:-1] &= gap
        np.testing.assert_array_equal(pi[r][distinct], ji[r][distinct])


@pytest.mark.parametrize("n,metric", [(129, "l2"), (5000, "ip")])
def test_bf16_twophase_matches_jax(n, metric):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 130)).astype(np.float32)
    q = rng.standard_normal((17, 130)).astype(np.float32)
    pd, pi, pc = T.topk_twophase(torch.from_numpy(q), torch.from_numpy(x).to(torch.bfloat16), 10,
                                 metric, with_certificate=True)
    jd, ji, jc = jax_topk_twophase(jnp.asarray(q), jnp.asarray(x, jnp.bfloat16), 10, metric,
                                   tile_n=1024, with_certificate=True, interpret=True)
    assert_topk_match(pd.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pc.all()

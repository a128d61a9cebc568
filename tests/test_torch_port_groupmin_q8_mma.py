"""The int8 phase 1 of the port's flat search on tensor cores
(image_search_engine_tpu_torch/ops/topk.py ``groupmin_q8``;
``csrc/groupmin_mma.cuh`` ``groupmin_mma_kernel<int8_t>``, the bf16 sweep's
template; ``ops/topk.mma_plan(..., itemsize=1)``).

The kernels run only on the card, where ``chip_smoke.py`` holds them to
their plain versions bit for bit. Here:

  (a) the tile plan for int8: d zero-padded to whole 32-code k-steps, the
      k-chunk, shared memory within the budget, every grid dimension within
      CUDA's limits, every (query, group) pair covered by exactly one
      phase-1 block; and the bf16 plan unchanged by the generalisation
      (checked against PR 8's arithmetic, copied here);
  (b) the routing, with a fake kernel library and ``_on_cuda`` patched:
      batches beyond ``DP4A_MAX_Q`` queries reach the tensor-core entry point
      with the plan's arguments, smaller ones the CUDA-core sweep, a
      non-zero return code raises, and CPU tensors never launch;
  (c) the port's int8 ``topk_twophase`` on the CPU (each kernel's plain
      version) against the JAX package's ``topk_twophase`` over the same
      int8 store in interpret mode at d = 130 (rows of no 16-byte multiple),
      Q = 17 (a partial 32-query tile on the card), N = 129 (every group
      rescored) and 5000, l2 and ip. Tolerance as in
      ``test_torch_port_int8.py``: distances rtol 1e-5 / atol 1e-4 (both
      sides sum the same exact int32 products; the JAX path rounds its f32
      epilogue in XLA's own order), ids equal where distances are distinct,
      id sets equal apart from ties at the k-th.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.index.store import quantize_rows_int8 as jax_quantize_rows
from image_search_engine_tpu.ops.topk_pallas import topk_twophase as jax_topk_twophase
from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import topk as T

RTOL, ATOL = 1e-5, 1e-4
GRID_MAX = 2 ** 31 - 1


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


@pytest.mark.parametrize("d", [1, 16, 32, 130, 2048, 2049])
@pytest.mark.parametrize("nq", [1, 7, 16, 17, 64, 2048, 4096])
def test_int8_plan(nq, d):
    for n in (1, 127, 128, 129, 200_003):
        p = T.mma_plan(nq, n, d, itemsize=1)
        assert (p.nq, p.n, p.d, p.itemsize) == (nq, n, d, 1)
        assert p.dp % 32 == 0 and d <= p.dp < d + 32  # whole 32-code k-steps
        assert p.kc % 32 == 0 and 32 <= p.kc <= p.dp and p.kc <= 256
        assert p.bq in T.MMA_BQ and p.bq >= min(nq, 128)
        assert 1 <= p.gps <= p.ngroups
        assert p.smem <= T._SMEM_BYTES
        # the shared-memory arithmetic counts bytes: one byte a code
        qrows, srows = (min(p.bq, nq + 1), T.GROUP) if p.resident else (0, T.GROUP + p.bq)
        wn = 8 // (2 if p.bq >= 32 else 1)
        assert p.smem == qrows * (p.dp + 16) + 2 * srows * (p.kc + 16) + wn * p.bq * 4
        assert 1 <= p.grid <= GRID_MAX
        assert_covers_once(p)


def test_int8_plan_at_the_phase4_shapes():
    # Q = 64 over 200,003 x 2048: a streamed 64-query tile, 256-code chunks,
    # two blocks an SM; the bench point: a resident 128-query tile, whole rows
    p = T.mma_plan(64, 200_003, 2048, itemsize=1)
    assert (p.bq, p.dp, p.kc, p.resident) == (64, 2048, 256, False)
    assert p.smem <= T._MMA_SMEM_TWO_BLOCKS
    p = T.mma_plan(2048, 10 ** 6, 128, itemsize=1)
    assert (p.bq, p.dp, p.kc, p.resident) == (128, 128, 128, True)


def test_int8_plan_takes_the_widest_rows_the_int32_sum_allows():
    p = T.mma_plan(4096, 10 ** 6, T.MAX_Q8_DIM - 1, itemsize=1)
    assert p.smem <= T._SMEM_BYTES and p.dp % 32 == 0
    with pytest.raises(ValueError):
        T.mma_plan(4, 10, 16, itemsize=4)


def pr8_bf16_plan(nq, n, d):
    """PR 8's bf16 tile plan, element arithmetic as it was: (bq, dp, kc,
    resident, gps, rescore_kc, smem, rescore_smem)."""
    def smem(bq, dp, kc, resident):
        wn = 8 // (2 if bq >= 32 else 1)
        qrows, srows = (min(bq, nq + 1), 128) if resident else (0, 128 + bq)
        return qrows * (dp + 8) * 2 + 2 * srows * (kc + 8) * 2 + wn * bq * 4

    dp = -(-d // 16) * 16
    kcs = sorted({min(dp, kc) for kc in (128, 64, 32, 16)}, reverse=True)
    bq = next(b for b in (16, 32, 64, 128) if b >= min(nq, 128))
    nqt, ng = -(-nq // bq), -(-n // 128)
    gps = min(ng, max(4, bq // 32, min(16, ng * nqt // 4096)))
    resident, kc = next((r, k) for limit in (113 * 1024, 200 * 1024) for r in (True, False)
                        for k in kcs if smem(bq, dp, k, r) <= limit)
    rkc = min(dp, 128)
    return (bq, dp, kc, resident, gps, rkc, smem(bq, dp, kc, resident),
            2 * (dp + 8) * 2 + 4 * 2 * 32 * (rkc + 8) * 2)


@pytest.mark.parametrize("d", [1, 16, 128, 130, 2048])
@pytest.mark.parametrize("nq", [1, 7, 16, 17, 2048, 4096])
def test_bf16_plan_unchanged(nq, d):
    for n in (1, 127, 128, 129, 10 ** 6):
        p = T.mma_plan(nq, n, d)
        assert p.itemsize == 2
        assert (p.bq, p.dp, p.kc, p.resident, p.gps, p.rescore_kc, p.smem,
                p.rescore_smem) == pr8_bf16_plan(nq, n, d)


@pytest.mark.parametrize("d,offset,want", [(128, 0, 16), (132, 0, 4), (130, 0, 1), (128, 4, 4),
                                           (128, 1, 1)])
def test_int8_copy_width(d, offset, want):
    # 16-byte copies need rows of 16-byte multiples at 16-byte aligned
    # addresses, 4-byte copies 4-byte ones; anything else copies code by code
    buf = torch.zeros(2 * d + 64, dtype=torch.int8)
    assert buf.data_ptr() % 16 == 0
    x = buf[offset:offset + 2 * d].view(2, d)
    q = torch.zeros(1, d, dtype=torch.int8)
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


def install(monkeypatch, rc=0, cuda=True):
    lib = FakeLibrary(rc)
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    if cuda:  # the wrappers take CPU tensors for CUDA ones
        monkeypatch.setattr(T, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(T, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return lib


def q8_inputs(nq, n=300, d=130):
    g = torch.Generator().manual_seed(nq)
    codes, scales = T.quantize_int8(torch.randn(n, d, generator=g))
    qi, qs = T.quantize_int8(torch.randn(nq, d, generator=g))
    norms = ((codes.float() * scales[:, None]) ** 2).sum(1)
    return qi, qs, codes, scales, norms


@pytest.mark.parametrize("nq", [5, 17, 64, 2048])
def test_int8_batches_reach_the_tensor_core_sweep_with_the_plan(monkeypatch, nq):
    lib = install(monkeypatch)
    qi, qs, codes, scales, norms = q8_inputs(nq)
    n, d = codes.shape
    before = T.groupmin_q8.launches
    mins = T.groupmin_q8(qi, qs, codes, scales, norms)
    assert T.groupmin_q8.launches == before + 1
    assert tuple(mins.shape) == (nq, T.num_groups(n))
    assert [c[0] for c in lib.calls] == ["ise_groupmin_q8_mma"]
    p = T.mma_plan(nq, n, d, itemsize=1)
    args = lib.calls[0][1]
    # q, qscale, norms, scales, x, out, nq, n, d, bq, dp, kc, gps, resident, smem, vec, stream
    assert args[:6] == (qi.data_ptr(), qs.data_ptr(), norms.data_ptr(), scales.data_ptr(),
                        codes.data_ptr(), mins.data_ptr())
    assert args[6:16] == (nq, n, d, p.bq, p.dp, p.kc, p.gps, int(p.resident), p.smem,
                          T._vec_mma(qi, codes))
    assert args[10] == 160  # d = 130 padded to five 32-code k-steps


@pytest.mark.parametrize("nq", [1, 2, 4])
def test_small_int8_batches_stay_on_the_cuda_core_sweep(monkeypatch, nq):
    lib = install(monkeypatch)
    qi, qs, codes, scales, norms = q8_inputs(nq, d=128)
    mins = T.groupmin_q8(qi, qs, codes, scales, norms)
    assert nq <= T.DP4A_MAX_Q
    assert [c[0] for c in lib.calls] == ["ise_groupmin_q8"]
    args = lib.calls[0][1]
    # q, qscale, norms, scales, x, out, nq, n, d, qt, vec, stream
    assert args[5:11] == (mins.data_ptr(), nq, codes.shape[0], 128, T._query_tile(nq, 128),
                          T._vec_q8(qi, codes))


@pytest.mark.parametrize("limit,nq,entry", [(0, 1, "ise_groupmin_q8_mma"),
                                            (64, 64, "ise_groupmin_q8")])
def test_the_batch_size_limit_picks_the_kernel(monkeypatch, limit, nq, entry):
    lib = install(monkeypatch)
    monkeypatch.setattr(T, "DP4A_MAX_Q", limit)
    T.groupmin_q8(*q8_inputs(nq))
    assert [c[0] for c in lib.calls] == [entry]


@pytest.mark.parametrize("nq", [1, 64])
def test_a_failed_int8_launch_raises(monkeypatch, nq):
    install(monkeypatch, rc=1)
    before = T.groupmin_q8.launches
    with pytest.raises(RuntimeError, match="groupmin_q8 kernel launch failed"):
        T.groupmin_q8(*q8_inputs(nq))
    assert T.groupmin_q8.launches == before


@pytest.mark.parametrize("nq", [1, 64])
def test_cpu_tensors_never_launch(monkeypatch, nq):
    lib = install(monkeypatch, cuda=False)
    before = T.groupmin_q8.launches
    args = q8_inputs(nq)
    got = T.groupmin_q8(*args)
    assert lib.calls == [] and T.groupmin_q8.launches == before
    assert torch.equal(got, T.groupmin_q8_ref(*args))


# ---------------------------------------------------------------------------
# (c) the int8 search against the JAX package's
# ---------------------------------------------------------------------------


def assert_topk_match(pd, pi, jd, ji):
    """Distances equal within tolerance; ids equal where distances are
    distinct; id sets equal apart from ties at the k-th distance."""
    np.testing.assert_allclose(pd, jd, rtol=RTOL, atol=ATOL)
    for r in range(jd.shape[0]):
        tol = ATOL + RTOL * np.abs(jd[r])
        gap = np.abs(np.diff(jd[r])) > tol[1:]
        distinct = np.ones(jd.shape[1], bool)
        distinct[1:] &= gap
        distinct[:-1] &= gap
        np.testing.assert_array_equal(pi[r][distinct], ji[r][distinct])
        kth = jd[r][-1]
        assert (set(pi[r][np.abs(pd[r] - kth) > tol].tolist())
                == set(ji[r][np.abs(jd[r] - kth) > tol].tolist()))


@pytest.mark.parametrize("n,metric", [(129, "l2"), (129, "ip"), (5000, "l2"), (5000, "ip")])
def test_int8_twophase_matches_jax(n, metric):
    rng = np.random.default_rng(n + len(metric))
    x = rng.standard_normal((n, 130)).astype(np.float32)
    q = rng.standard_normal((17, 130)).astype(np.float32)
    codes, scales = jax_quantize_rows(x)
    deq = codes.astype(np.float32) * scales[:, None]
    norms = (deq.astype(np.float64) ** 2).sum(1).astype(np.float32)
    pd, pi, pc = T.topk_twophase(
        torch.from_numpy(q), torch.from_numpy(codes), 10, metric,
        x_norms=torch.from_numpy(norms), x_scale=torch.from_numpy(scales), with_certificate=True)
    jd, ji, jc = jax_topk_twophase(
        jnp.asarray(q), jnp.asarray(codes), 10, metric, x_norms=jnp.asarray(norms),
        x_scale=jnp.asarray(scales), tile_n=1024, with_certificate=True, interpret=True)
    assert_topk_match(pd.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pc.all()

"""The plan of the port's merged two-phase search (image_search_engine_tpu_torch/
ops/topk_merged.py ``merged_plan``, ``MergedPlan``; ``csrc/topk_merged.cu``)
and the routing of ``merged_candidates`` with a fake kernel library.

The kernel runs only on the card, where ``chip_smoke.py`` holds its outputs
to the three kernels of ``topk_twophase`` bit for bit. Here, over Q in [1,
5000], N in [1, 2M], both store dtypes and 132 SMs (hypothesis, bounded
examples):

  (a) the order the kernel dispenses its work items in (``schedule``, the
      kernel's ``next_item`` arithmetic): every sweep (query
      tile, slice), every query's select and every (query, group) slot
      comes exactly once, and every item's waits point to earlier items (a
      select after its unit's whole sweep, a rescore after its queries'
      selects), so the persistent launch cannot deadlock;
  (b) the route and the tiles are the two-phase search's
      (``ops/topk._on_tensor_cores``, ``mma_plan``, ``wgmma_plan``,
      ``_query_tile``), a unit holds at least ``MERGED_UNIT_QUERIES``
      queries but the last, and a batch of at most that many is one unit;
      the shared memory keeps the sweep's blocks an SM;
  (c) ``merged_candidates`` on a fake library: one ``ise_topk_merged`` call
      (``ise_topk_merged_tf32`` on the f32 warpgroup route) with the plan's
      arguments and zeroed counters, launches counted by route, a failed
      launch raising.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.ops import topk_merged as TM

SMS = 132
SWEEP, SELECT, RESCORE = (TM.SCHEDULE_KINDS.index(k) for k in (TM.SWEEP, TM.SELECT, TM.RESCORE))


def store_like(n: int, d: int, dtype: torch.dtype, aligned: bool) -> torch.Tensor:
    """An (n, d) view of one or two elements at a 16-byte boundary or 4
    bytes past one: what the routing rule reads of a store."""
    base = torch.empty(2, dtype=dtype)
    return (base[:1] if aligned else base[1:]).expand(n, d)


def check_schedule(plan):
    kinds, units, index = plan.schedule()
    assert len(kinds) == plan.total_items
    tickets = np.arange(len(kinds))
    # every sweep item once: the sweep kernel's blocks, each in its tile's unit
    sw = kinds == SWEEP
    assert np.array_equal(np.sort(index[sw]), np.arange(plan.nslices * plan.nqt))
    assert np.array_equal(units[sw], (index[sw] % plan.nqt) // plan.tiles_per_unit)
    # every query's select once, in its unit, after its unit's whole sweep
    sel = kinds == SELECT
    assert np.array_equal(np.sort(index[sel]), np.arange(plan.nq))
    assert np.array_equal(units[sel], (index[sel] // plan.bq) // plan.tiles_per_unit)
    last_sweep = np.full(plan.units, -1)
    np.maximum.at(last_sweep, units[sw], tickets[sw])
    assert (last_sweep[units[sel]] < tickets[sel]).all()
    # every slot once (four blocks a slot on CUDA cores; two slots an item on
    # "mma" but at a unit's end), after its queries' selects
    rs = kinds == RESCORE
    per = 4 if plan.route == "cuda" else 1
    first = index[rs] // per  # an item's first slot
    if plan.route == "mma":
        end = np.array([plan.unit_queries(u)[1] * plan.t for u in range(plan.units)])[units[rs]]
        two = first + 1 < end
        covered = np.concatenate([first, first[two] + 1])
        last = np.where(two, first + 1, first)
    else:
        covered, last = index[rs], first
    assert np.array_equal(np.sort(covered), np.arange(plan.nq * plan.t * per))
    sel_ticket = np.empty(plan.nq, dtype=np.int64)
    sel_ticket[index[sel]] = tickets[sel]
    for slot in (first, last):
        assert (sel_ticket[slot // plan.t] < tickets[rs]).all()
    assert (first // plan.t // plan.bq // plan.tiles_per_unit == units[rs]).all()


@settings(max_examples=40, deadline=None)
@given(nq=st.integers(1, 5000), n=st.integers(1, 2_000_000),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]),
       d=st.sampled_from([16, 64, 128, 130, 2048]), k=st.integers(1, 128),
       aligned=st.booleans(), units=st.sampled_from([None, None, 1, 3]))
def test_every_item_once_and_every_wait_on_an_earlier_item(nq, n, dtype, d, k, aligned, units):
    t = min(k + 2, T.num_groups(n))
    plan = TM.merged_plan(nq, n, d, dtype, SMS, t, units=units, aligned=aligned)
    assume(plan.total_items <= 1_500_000)
    check_schedule(plan)
    # (b) the route and tiles of the two-phase search, and the unit rule
    x = store_like(n, d, dtype, aligned)
    assert (plan.route != "cuda") == T._on_tensor_cores(x, nq)
    if plan.route == "mma":
        mp = T.mma_plan(nq, n, d)
        assert (plan.bq, plan.gps, plan.dp, plan.kc, plan.resident) == (
            mp.bq, mp.gps, mp.dp, mp.kc, mp.resident)
        if mp.smem <= T._MMA_SMEM_TWO_BLOCKS:
            assert plan.smem <= T._MMA_SMEM_TWO_BLOCKS and plan.blocks_per_sm == 2
    elif plan.route == "tf32":
        wp = T.wgmma_plan(nq, n, SMS)
        assert (plan.bq, plan.gps, plan.blocks_per_sm) == (wp.bq, wp.gps, 1)
    else:
        assert (plan.bq, plan.gps) == (T._query_tile(nq, d * 4), 1)
    if units is None:
        sizes = [hi - lo for lo, hi in map(plan.unit_queries, range(plan.units))]
        assert plan.units == 1 if nq <= TM.MERGED_UNIT_QUERIES else \
            all(s >= TM.MERGED_UNIT_QUERIES for s in sizes[:-1])
        assert (plan.tiles_per_unit - 1) * plan.bq < TM.MERGED_UNIT_QUERIES or plan.units == 1
    else:
        assert plan.units <= units and plan.units == -(-plan.nqt // plan.tiles_per_unit)
    assert plan.grid == SMS * plan.blocks_per_sm
    assert plan.smem <= (TM._tf32_smem(plan.bq) if plan.route == "tf32" else T._SMEM_BYTES)


@pytest.mark.parametrize("nq,n,d,dtype,route,units", [
    (4096, 1_000_000, 128, torch.bfloat16, "mma", 8),   # bench.py's point: 8 units of 512
    (600, 20_003, 64, torch.float32, "tf32", 2),        # 512 + 88 queries
    (1100, 20_003, 130, torch.float32, "cuda", 3),      # rows of no whole 16-byte units
    (1100, 20_003, 64, torch.bfloat16, "mma", 3),
    (64, 1_000_000, 2048, torch.bfloat16, "mma", 1),
    (1, 1_000_000, 2048, torch.float32, "cuda", 1),
])
def test_the_main_shapes_plans(nq, n, d, dtype, route, units):
    plan = TM.merged_plan(nq, n, d, dtype, SMS, 22)
    assert (plan.route, plan.units) == (route, units)
    check_schedule(plan)
    one = TM.merged_plan(nq, n, d, dtype, SMS, 22, units=1)
    assert one.units == 1 and one.total_items == plan.total_items
    # the order: the sweeps of units 0 and 1, then unit 0's select and
    # rescore, the sweep of unit 2, unit 1's select and rescore, ...
    want = [(TM.SWEEP, 0)] + [p for u in range(1, units) for p in (
        (TM.SWEEP, u), (TM.SELECT, u - 1), (TM.RESCORE, u - 1))] + [
        (TM.SELECT, units - 1), (TM.RESCORE, units - 1)]
    assert plan.phases() == want


def test_the_bf16_rescore_and_the_select_fit_beside_the_sweep():
    # 1M x 2048 bf16 at Q = 1: the rescore's two pairs take a 64-column
    # chunk (the two-phase rescore's 128 would leave one block an SM)
    plan = TM.merged_plan(1, 1_000_000, 2048, torch.bfloat16, SMS, 22)
    assert plan.rescore_kc == 64 and plan.smem <= T._MMA_SMEM_TWO_BLOCKS
    assert plan.smem == max(T.mma_plan(1, 1_000_000, 2048).smem,
                            2 * TM._round16(TM._rescore_mma_smem(plan.dp, 64)),
                            TM._select_smem(22))
    # t beyond 256 sorts in shared memory, beyond 4096 in a global scratch
    assert TM._select_smem(300) - TM._select_smem(256) == 512 * 12
    assert TM._select_smem(5000) - TM._select_smem(256) == 8 * 256 * 4
    with pytest.raises(ValueError, match="t=9"):
        TM.merged_plan(2, 1000, 16, torch.float32, SMS, 9)
    with pytest.raises(ValueError, match="units=0"):
        TM.merged_plan(2, 1000, 16, torch.float32, SMS, 3, units=0)


# ---------------------------------------------------------------------------
# (c) merged_candidates on a fake library
# ---------------------------------------------------------------------------


class FakeLibrary:
    """Records each entry point's arguments and returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls, self.entries = rc, [], []

    def ise_error_string(self, err):
        return b"fake error"

    def ise_topk_merged(self, *args):
        return self._record("ise_topk_merged", args)

    def ise_topk_merged_tf32(self, *args):
        return self._record("ise_topk_merged_tf32", args)

    def _record(self, entry, args):
        self.entries.append(entry)
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake_cuda(monkeypatch):
    def install(rc=0):
        lib = FakeLibrary(rc)
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        monkeypatch.setattr(TM, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(TM, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: SimpleNamespace(multi_processor_count=SMS))
        seen = []
        zeros = torch.zeros

        def spy(*a, **kw):  # the counters the wrapper hands the kernel
            seen.append(zeros(*a, **kw))
            return seen[-1]
        monkeypatch.setattr(torch, "zeros", spy)
        return lib, seen
    return install


@pytest.mark.parametrize("nq,dtype,d,route", [
    (1, torch.float32, 64, "cuda"), (17, torch.float32, 64, "tf32"),
    (17, torch.float32, 130, "cuda"), (17, torch.bfloat16, 130, "mma"),
    (600, torch.bfloat16, 16, "mma"),
])
def test_one_launch_on_the_plan(fake_cuda, nq, dtype, d, route):
    lib, zeros = fake_cuda()
    g = torch.Generator().manual_seed(nq)
    x = torch.randn(3000, d, generator=g).to(dtype)
    q = torch.randn(nq, d, generator=g).to(dtype)
    norms = (x.float() ** 2).sum(1)
    TM.merged_candidates.launches = TM.merged_candidates.tensor_core_launches = 0
    scores, cand, thr, mins = TM.merged_candidates(q, x, norms, 5)
    plan = TM.merged_plan(nq, 3000, d, dtype, SMS, 5)
    assert plan.route == route and len(lib.calls) == 1 and lib.entries == [
        "ise_topk_merged_tf32" if route == "tf32" else "ise_topk_merged"]
    a = lib.calls[0]
    assert a[0] == TM.ROUTES.index(route) and a[1] == q.data_ptr() and a[5] == x.data_ptr()
    assert (a[6], a[7], a[8], a[9]) == (mins.data_ptr(), cand.data_ptr(), thr.data_ptr(),
                                        scores.data_ptr())
    assert (a[2] != 0 and a[3] != 0) if route == "tf32" else a[2:4] == (0, 0)
    assert a[13:-1] == (nq, 3000, d, 5, plan.bq, plan.gps, plan.tiles_per_unit, plan.dp,
                        plan.kc, plan.rescore_kc, int(plan.resident),
                        {"cuda": T._vec(x), "mma": T._vec_mma(q, x), "tf32": 0}[route],
                        plan.grid, plan.smem)
    counters = zeros[-1]
    assert counters.dtype == torch.int32 and counters.numel() == 1 + plan.units + nq
    assert a[12] == counters.data_ptr() and not counters.any()
    assert (TM.merged_candidates.launches, TM.merged_candidates.tensor_core_launches) == (
        1, int(route != "cuda"))
    TM.merged_candidates(q, x, norms, 5, units=1)
    assert lib.calls[1][19] == plan.nqt  # one unit of every query tile


def test_a_failed_launch_raises_and_counts_nothing(fake_cuda):
    fake_cuda(rc=1)
    x = torch.randn(1000, 32)
    q = torch.randn(4, 32)
    TM.merged_candidates.launches = TM.merged_candidates.tensor_core_launches = 0
    with pytest.raises(RuntimeError, match="topk_merged kernel launch failed"):
        TM.merged_candidates(q, x, (x * x).sum(1), 4)
    assert (TM.merged_candidates.launches, TM.merged_candidates.tensor_core_launches) == (0, 0)

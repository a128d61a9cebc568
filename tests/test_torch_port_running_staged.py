"""The running top-k's staged kernel, a lane per row
(image_search_engine_tpu_torch/ops/topk.py ``topk_running``,
``running_plan``; ``csrc/topk_running_rows.cu``).

The kernel runs only on the card, where ``chip_smoke.py`` holds it to its
plain version (ids equal but for near ties) beside the kernel it replaced.
Here:

  (a) the launch plan's arithmetic: shared memory within a block's 227 KB,
      at least the kernel's layout and the warps' lists; two blocks an SM
      where the query tile leaves them two stages each and holds at most 4
      queries; the slices in whole 256-row tiles, covering the store, one
      wave of blocks, each warp at least k rows;
  (b) the routing, with a fake kernel library and ``_on_cuda`` patched: the
      wrapper calls the staged entry point with the plan's fields (and the
      Tensor Memory Accelerator only for rows of whole 16-byte units), the
      warp-per-row one only when ``RUNNING_ROUTE`` is forced, launches
      counted per route, a failed launch raises and counts nothing.
"""

import contextlib
import types

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import topk as T

SMS = 132
SM_SMEM, BLOCK_SMEM = 233_472, 232_448  # an H100 SM's shared memory, a block's at most
STAGE = 256 * 128  # a ring stage: 256 rows x 128 bytes


def kernel_smem(qt, dpad, stages, k):
    """running_rows_smem in csrc/topk_running_rows.cu, written out."""
    return 2 * 8 * 8 + 1024 + max(stages * STAGE + qt * dpad * 4, 8 * qt * k * 8)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(nq=st.integers(1, 600), n=st.integers(1, 3_000_000), d=st.integers(1, 12_000),
       itemsize=st.sampled_from([2, 4]), k=st.integers(1, 128),
       sms=st.sampled_from([1, 7, 132]))
def test_plan_fits_and_covers_the_store(nq, n, d, itemsize, k, sms):
    p = T.running_plan(nq, n, d, itemsize, k, sms)
    span = 128 // itemsize
    assert p.dpad % span == 0 and 0 <= p.dpad - d < span
    # the smallest tile of 1, 2, 4 or 8 that holds min(Q, 8), halved only while it
    # and two stages do not fit a block
    full = next(t for t in (1, 2, 4, 8) if t >= min(nq, 8))
    assert p.qt <= full and (p.qt == full or kernel_smem(2 * p.qt, p.dpad, 2, k) > BLOCK_SMEM)
    assert 2 <= p.stages <= 8
    assert p.smem == kernel_smem(p.qt, p.dpad, p.stages, k)
    assert p.smem <= min(BLOCK_SMEM, SM_SMEM // p.blocks_per_sm - 1024)
    # two blocks an SM only for tiles of at most 4 queries (the register budget)
    assert p.blocks_per_sm in (1, 2) and (p.blocks_per_sm == 1 or p.qt <= 4)
    # slices of whole tiles that cover the store, no empty one
    assert p.rows_per_slice % 256 == 0
    assert (p.nslices - 1) * p.rows_per_slice < n <= p.nslices * p.rows_per_slice
    # one wave, and each of a slice's 8 warps sees k rows or more
    assert p.nslices * p.nqt <= max(p.blocks_per_sm * sms, p.nqt)
    assert p.nslices <= max(1, n // (8 * k))


@pytest.mark.parametrize("nq,itemsize,d,qt,stages,bps,nslices", [
    (1, 4, 2048, 1, 3, 2, 261),   # Q = 1 f32: two blocks an SM, three stages each
    (8, 4, 2048, 8, 5, 1, 131),   # Q = 8: the 64 KB query tile, one block with five stages
    (1, 2, 2048, 1, 3, 2, 261),   # Q = 1 bf16
    (4, 4, 2048, 4, 2, 2, 261),
    (8, 4, 8192, 4, 3, 1, 66),    # 32 KB query rows: tiles of 4 queries
])
def test_main_path_plans(nq, itemsize, d, qt, stages, bps, nslices):
    p = T.running_plan(nq, 10 ** 6, d, itemsize, 20, SMS)
    assert (p.qt, p.stages, p.blocks_per_sm, p.nslices) == (qt, stages, bps, nslices)


def test_small_store_is_one_slice():
    p = T.running_plan(3, 100, 64, 4, 20, SMS)
    assert (p.nslices, p.rows_per_slice) == (1, 256)


def test_lists_fit_when_they_outgrow_the_ring():
    # d = 16 at k = 128: 8 warps x 8 queries x 128 pairs (64 KB) outgrow the
    # ring's two stages and the tile
    p = T.running_plan(8, 10 ** 5, 16, 4, 128, SMS)
    assert p.smem >= 1024 + 8 * 8 * 128 * 8


def test_plan_refuses():
    with pytest.raises(ValueError, match="query row"):
        T.running_plan(1, 1000, 60_000, 4, 20, SMS)
    for bad in ((0, 10, 8, 4, 20), (1, 10, 8, 4, 0), (1, 10, 8, 4, 129), (1, 10, 8, 1, 20)):
        with pytest.raises(ValueError):
            T.running_plan(*bad, SMS)


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
    """A fake kernel library behind the wrapper, which takes CPU tensors for
    CUDA ones on a card of 132 SMs; launch counts start at 0 and are put
    back after."""
    fn = T.topk_running
    keep = {a: getattr(fn, a) for a in ("launches", "staged_launches", "row_dot_launches")}
    T.reset_launch_counts()

    def install(rc=0):
        lib = FakeLibrary(rc)
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        monkeypatch.setattr(T, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(T, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
        return lib
    yield install
    for a, v in keep.items():
        setattr(fn, a, v)


def inputs(nq=3, n=700, d=64, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(nq, d, generator=g), torch.randn(n, d, generator=g).to(dtype)


def counts():
    fn = T.topk_running
    return fn.launches, fn.staged_launches, fn.row_dot_launches


@pytest.mark.parametrize("nq,n,d,dtype,tma", [
    (1, 5000, 2048, torch.float32, 1), (8, 700, 64, torch.float32, 1),
    (3, 700, 130, torch.bfloat16, 0),  # 260-byte rows: copied by the producer warp
    (9, 300, 130, torch.float32, 0), (17, 1000, 16, torch.bfloat16, 1)])
@pytest.mark.parametrize("k", [1, 20, 64, 128])
def test_calls_the_staged_entry_point_on_the_plan(fake_cuda, nq, n, d, dtype, tma, k):
    lib = fake_cuda()
    q, x = inputs(nq, n, d, dtype)
    dist, ids = T.topk_running(q, x, k)
    assert tuple(dist.shape) == tuple(ids.shape) == (nq, k)
    assert [c[0] for c in lib.calls] == ["ise_topk_running_rows"]
    p = T.running_plan(nq, n, d, x.element_size(), k, SMS)
    args = lib.calls[0][1]
    # dtype, q, norms, x, part_v, part_i, out_v, out_i, nq, n, d, k, qt, nslices,
    # rows_per_slice, stages, smem, tma, stream
    assert args[0] == (0 if dtype == torch.float32 else 1)
    assert args[8:] == (nq, n, d, k, p.qt, p.nslices, p.rows_per_slice, p.stages, p.smem, tma, 0)
    assert counts() == (1, 1, 0)


def test_row_dot_route_only_when_forced(fake_cuda, monkeypatch):
    lib = fake_cuda()
    q, x = inputs()
    monkeypatch.setattr(T, "RUNNING_ROUTE", "row_dot")
    T.topk_running(q, x, 20, "ip")
    assert [c[0] for c in lib.calls] == ["ise_topk_running"]
    nq, d = q.shape
    qt = T._query_tile(nq, d * 4)
    # ..., nq, n, d, k, qt, nslices, vec, stream: the replaced kernel's own plan
    assert lib.calls[0][1][8:] == (nq, x.shape[0], d, 20, qt,
                                   T._running_slices(x.shape[0], 20, -(-nq // qt), SMS), 4, 0)
    assert counts() == (1, 0, 1)
    monkeypatch.setattr(T, "RUNNING_ROUTE", "staged")
    T.topk_running(q, x, 20)
    assert lib.calls[-1][0] == "ise_topk_running_rows"
    assert counts() == (2, 1, 1)
    T.reset_launch_counts()
    assert counts() == (0, 0, 0)


def test_unknown_route_raises(fake_cuda, monkeypatch):
    lib = fake_cuda()
    monkeypatch.setattr(T, "RUNNING_ROUTE", "dp4a")
    q, x = inputs()
    with pytest.raises(ValueError, match="RUNNING_ROUTE"):
        T.topk_running(q, x, 5)
    assert lib.calls == [] and counts() == (0, 0, 0)


@pytest.mark.parametrize("route", T.RUNNING_ROUTES)
def test_failed_launch_raises_and_counts_nothing(fake_cuda, monkeypatch, route):
    lib = fake_cuda(rc=2)
    monkeypatch.setattr(T, "RUNNING_ROUTE", route)
    q, x = inputs()
    with pytest.raises(RuntimeError, match="fake error"):
        T.topk_running(q, x, 10)
    assert len(lib.calls) == 1
    assert counts() == (0, 0, 0)


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_kernels, "library", no_library)
    q, x = inputs()
    before = counts()
    for route in T.RUNNING_ROUTES:
        monkeypatch.setattr(T, "RUNNING_ROUTE", route)
        for a, b in zip(T.topk_running(q, x, 7), T.topk_running_ref(q, x, 7)):
            assert torch.equal(a, b)
    assert counts() == before

"""The phase-1 prototype ``groupmin_chunked`` on the bf16 warpgroup-MMA sweep
(image_search_engine_tpu_torch/ops/groupmin_variants.py ``chunked_plan``;
``csrc/groupmin_wgmma.cuh``, entry point in
``csrc/groupmin_chunked_wgmma.cu``).

The kernel runs only on the card, where ``chip_smoke.py`` holds it to its
plain version and to production ``groupmin``. Here:

  (a) the tile plan's arithmetic: shared memory within the 227 KB a block
      may have and equal to the kernel's layout, every (query, group) pair
      in exactly one block, one wave of blocks, and what ``chunk`` sets (the
      rows the ring keeps in flight, as many stages as fit);
  (b) the routing, with a fake kernel library and ``_on_cuda`` patched: the
      wrapper calls the warpgroup-MMA entry point with the plan's fields,
      the CUDA-core one only when ``ROUTE`` is forced, launches counted per
      route, a failed launch raises and counts nothing, CPU tensors never
      reach the library.
"""

import contextlib
import types

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import groupmin_variants as GV
from image_search_engine_tpu_torch.ops import topk as T

SMS = 132
BLOCK_SMEM = 232_448  # the H100's dynamic shared memory per block (227 KB)


def kernel_smem(bq, dp, kc, stages, resident):
    """groupmin_wgmma_smem in csrc/groupmin_wgmma.cuh, written out."""
    stage = (kc // 64) * 128 * 128 + (0 if resident else (kc // 64) * bq * 128)
    return 1024 + (bq * dp * 2 if resident else 0) + stages * stage + (2 * stages + 1) * 8


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------


@settings(max_examples=150, deadline=None)
@given(nq=st.integers(1, 5000), n=st.integers(1, 2_000_000), d8=st.integers(1, 320),
       chunk=st.sampled_from(GV.CHUNKS), sms=st.sampled_from([1, 7, 132]))
def test_plan_fits_and_covers_every_pair_once(nq, n, d8, chunk, sms):
    d = 8 * d8
    p = GV.chunked_plan(nq, n, d, chunk, sms)
    assert p.bq == (128 if nq <= 128 else 256)
    assert p.kc == (64 if d <= 64 else 128)
    assert p.dp % p.kc == 0 and 0 <= p.dp - d < p.kc
    assert 2 <= p.stages and p.smem == kernel_smem(p.bq, p.dp, p.kc, p.stages, p.resident)
    assert p.smem <= BLOCK_SMEM
    # resident whenever the tile fits beside two stages
    fits = kernel_smem(p.bq, p.dp, p.kc, 2, True) <= BLOCK_SMEM
    assert p.resident == fits
    # one wave: the grid within the SMs unless the query tiles alone exceed them
    assert p.grid <= max(sms, p.nqt)
    # every (query tile, group) pair in exactly one block: the slices tile the groups
    q0, q1, g0, g1 = p.block_tiles(torch.arange(p.grid))
    cover = torch.zeros(p.nqt, p.ngroups, dtype=torch.int32)
    for a, b, c, e in zip((q0 // p.bq).tolist(), q1.tolist(), g0.tolist(), g1.tolist()):
        assert c < e
        cover[a, c:e] += 1
    assert bool((cover == 1).all())
    tiles = sorted(set(zip(q0.tolist(), q1.tolist())))
    assert tiles == [(t * p.bq, min((t + 1) * p.bq, nq)) for t in range(p.nqt)]


@pytest.mark.parametrize("nq,d,chunk,stages,rows", [
    (2048, 128, 512, 4, 512),   # bench.py's point: a group a stage, 4 groups in flight
    (2048, 128, 1024, 5, 640),  # 1024 rows would be 256 KB: as many as fit beside the tile
    (4096, 128, 512, 4, 512),
    (4096, 128, 1024, 5, 640),
    (64, 128, 512, 4, 512),     # a 128-query tile leaves room for more
    (64, 128, 1024, 6, 768),
    (300, 8, 512, 4, 512),      # d <= 64: stages of one 64-column span
    (300, 8, 1024, 8, 1024),
])
def test_chunk_sets_the_rows_in_flight(nq, d, chunk, stages, rows):
    p = GV.chunked_plan(nq, 10 ** 6, d, chunk, SMS)
    assert p.resident and p.nkc == 1
    assert (p.stages, p.rows_in_flight) == (stages, rows)
    assert p.stages == min(chunk // T.GROUP, (BLOCK_SMEM - kernel_smem(p.bq, p.dp, p.kc, 0, True))
                           // (p.stage_bytes + 16))


def test_bench_point_plan():
    # 8 query tiles of 256, 16 slices of 489 groups: 128 blocks on the 132
    # SMs, the tile's 8 blocks of a slice reading it together
    p = GV.chunked_plan(2048, 10 ** 6, 128, 512, SMS)
    assert (p.bq, p.nqt, p.gps, p.grid, p.kc, p.nkc) == (256, 8, 489, 128, 128, 1)
    assert p.smem == 1024 + 65536 + 4 * 32768 + 9 * 8


def test_wide_rows_stream_the_query_tile():
    # d = 2048: a 256-query tile is 1 MB; it arrives with each stage (2 x 16
    # KB of rows and 2 x 32 KB of queries), 16 stages a group
    p = GV.chunked_plan(2048, 10 ** 6, 2048, 512, SMS)
    assert not p.resident and p.nkc == 16
    assert p.stage_bytes == 2 * 16384 + 2 * 256 * 128
    assert p.stages == 2 and p.smem <= BLOCK_SMEM
    assert p.rows_in_flight == 2 * 128 // 16


@pytest.mark.parametrize("nq,n,d,chunk", [(0, 10, 128, 512), (4, 0, 128, 512), (4, 10, 130, 512),
                                          (4, 10, 4, 512), (4, 10, 128, 256),
                                          (4, 2 ** 31, 128, 512)])
def test_plan_refuses(nq, n, d, chunk):
    with pytest.raises(ValueError):
        GV.chunked_plan(nq, n, d, chunk, SMS)


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
    fn = GV.groupmin_chunked
    keep = {a: getattr(fn, a) for a in ("launches", "mma_launches", "cuda_core_launches")}
    GV.reset_launch_counts()

    def install(rc=0):
        lib = FakeLibrary(rc)
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        monkeypatch.setattr(GV, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(GV, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: types.SimpleNamespace(multi_processor_count=SMS))
        return lib
    yield install
    for a, v in keep.items():
        setattr(fn, a, v)


def inputs(nq=17, n=300, d=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).to(torch.bfloat16)
    q = torch.randn(nq, d, generator=g).to(torch.bfloat16)
    return q, x, (x.float() ** 2).sum(1)


def counts():
    fn = GV.groupmin_chunked
    return fn.launches, fn.mma_launches, fn.cuda_core_launches


@pytest.mark.parametrize("nq,n,d", [(17, 300, 128), (129, 5000, 8), (2048, 1000, 128),
                                    (300, 700, 1040)])
@pytest.mark.parametrize("chunk", GV.CHUNKS)
def test_calls_the_warpgroup_mma_entry_point_on_the_plan(fake_cuda, chunk, nq, n, d):
    lib = fake_cuda()
    q, x, norms = inputs(nq, n, d)
    out = GV.groupmin_chunked(q, x, norms, chunk)
    assert tuple(out.shape) == (T.num_groups(n), nq) and out.dtype == torch.float32
    assert [c[0] for c in lib.calls] == ["ise_groupmin_chunked_wgmma"]
    p = GV.chunked_plan(nq, n, d, chunk, SMS)
    # q, norms, x, out, nq, n, d, bq, kc, stages, gps, resident, smem, stream
    assert lib.calls[0][1] == (q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq,
                               n, d, p.bq, p.kc, p.stages, p.gps, int(p.resident), p.smem, 0)
    assert counts() == (1, 1, 0)


def test_cuda_core_route_only_when_forced(fake_cuda, monkeypatch):
    lib = fake_cuda()
    q, x, norms = inputs()
    monkeypatch.setattr(GV, "ROUTE", "cuda_core")
    out = GV.groupmin_chunked(q, x, norms, 1024)
    assert [c[0] for c in lib.calls] == ["ise_groupmin_chunked"]
    # q, norms, x, out, nq, n, d, chunk, stream
    assert lib.calls[0][1] == (q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(),
                               q.shape[0], x.shape[0], x.shape[1], 1024, 0)
    assert counts() == (1, 0, 1)
    monkeypatch.setattr(GV, "ROUTE", "mma")
    GV.groupmin_chunked(q, x, norms, 512)
    assert lib.calls[-1][0] == "ise_groupmin_chunked_wgmma"
    assert counts() == (2, 1, 1)
    GV.reset_launch_counts()
    assert counts() == (0, 0, 0)


@pytest.mark.parametrize("route", GV.ROUTES)
def test_failed_launch_raises_and_counts_nothing(fake_cuda, monkeypatch, route):
    lib = fake_cuda(rc=2)
    monkeypatch.setattr(GV, "ROUTE", route)
    q, x, norms = inputs()
    with pytest.raises(RuntimeError, match="fake error"):
        GV.groupmin_chunked(q, x, norms, 512)
    assert len(lib.calls) == 1
    assert counts() == (0, 0, 0)


def test_rows_the_tensor_map_cannot_tile_raise(fake_cuda):
    lib = fake_cuda()
    q, x, norms = inputs(d=130)
    with pytest.raises(ValueError, match="16-byte"):
        GV.groupmin_chunked(q, x, norms, 512)
    assert lib.calls == [] and counts() == (0, 0, 0)


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_kernels, "library", no_library)
    q, x, norms = inputs(nq=9, n=700, d=48)
    before = counts()
    for route in GV.ROUTES:
        monkeypatch.setattr(GV, "ROUTE", route)
        for c in GV.CHUNKS:
            assert torch.equal(GV.groupmin_chunked(q, x, norms, c),
                               GV.groupmin_chunked_ref(q, x, norms))
    assert counts() == before

"""The phase-1 prototypes ``groupmin_width`` and ``groupmin_two_level`` on
the bf16 tensor-core sweep (image_search_engine_tpu_torch/ops/
groupmin_variants.py; ``csrc/groupmin_mma.cuh`` ``WidthMins``,
``TwoLevelMins``; entry points in ``csrc/groupmin_variants.cu``).

The kernels run only on the card, where ``chip_smoke.py`` holds them to
their plain versions and to production ``groupmin`` bit for bit. Here:

  (a) the routing, with a fake kernel library and ``_on_cuda`` patched:
      each wrapper calls its tensor-core entry point with ``mma_plan``'s
      fields and ``_vec_mma`` (two-level: :func:`two_level_plan`, v2's
      staging counted), for every width and layout; the CUDA-core entry
      points only when ``ROUTE`` is forced; launches counted per route; a
      failed launch raises and counts nothing; CPU tensors never reach the
      library;
  (b) v2's staging in the plan's shared memory: two blocks an SM at the
      bench point and at each query tile, the other layouts and the widths
      on production's own plan;
  (c) the output policies' epilogue emulated in numpy as the kernel runs
      it (per-warp mins of 128 / WN contiguous rows, then each policy's
      fminf over whole warps and its index arithmetic) against the plain
      versions: bit for bit, with the rows past N at +inf.
"""

import contextlib

import numpy as np
import pytest
import torch

from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import groupmin_variants as GV
from image_search_engine_tpu_torch.ops import topk as T


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
    CUDA ones; launch counts start at 0 and are put back after."""
    keep = {fn: {a: getattr(fn, a) for a in ("launches", "mma_launches", "cuda_core_launches")}
            for fn in (GV.groupmin_width, GV.groupmin_two_level)}
    GV.reset_launch_counts()

    def install(rc=0):
        lib = FakeLibrary(rc)
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        monkeypatch.setattr(GV, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(GV, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        return lib
    yield install
    for fn, attrs in keep.items():
        for a, v in attrs.items():
            setattr(fn, a, v)


def inputs(nq=17, n=300, d=130, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).to(torch.bfloat16)
    q = torch.randn(nq, d, generator=g).to(torch.bfloat16)
    return q, x, (x.float() ** 2).sum(1)


def counts(fn):
    return fn.launches, fn.mma_launches, fn.cuda_core_launches


# ---------------------------------------------------------------------------
# (a) routing
# ---------------------------------------------------------------------------

SHAPES = [(17, 300, 130), (64, 5000, 128), (2048, 1000, 128)]


@pytest.mark.parametrize("nq,n,d", SHAPES)
@pytest.mark.parametrize("group", GV.WIDTHS)
def test_width_calls_the_tensor_core_entry_point_on_mma_plan(fake_cuda, group, nq, n, d):
    lib = fake_cuda()
    q, x, norms = inputs(nq, n, d)
    out = GV.groupmin_width(q, x, norms, group)
    assert tuple(out.shape) == (-(-n // group), nq) and out.dtype == torch.float32
    assert [c[0] for c in lib.calls] == ["ise_groupmin_width_mma"]
    p = T.mma_plan(nq, n, d)
    # q, norms, x, out, nq, n, d, group, bq, dp, kc, gps, resident, smem, vec, stream
    assert lib.calls[0][1] == (q.data_ptr(), norms.data_ptr(), x.data_ptr(), out.data_ptr(), nq,
                               n, d, group, p.bq, p.dp, p.kc, p.gps, int(p.resident), p.smem,
                               T._vec_mma(q, x), 0)
    assert counts(GV.groupmin_width) == (1, 1, 0)


@pytest.mark.parametrize("nq,n,d", SHAPES)
@pytest.mark.parametrize("layout", GV.LAYOUTS)
def test_two_level_calls_the_tensor_core_entry_point_on_its_plan(fake_cuda, layout, nq, n, d):
    lib = fake_cuda()
    q, x, norms = inputs(nq, n, d)
    gmin, smin = GV.groupmin_two_level(q, x, norms, layout)
    nsub = -(-n // GV.SUB)
    assert tuple(gmin.shape) == (T.num_groups(n), nq) and gmin.dtype == torch.float32
    assert tuple(smin.shape) == (nq, nsub) and smin.dtype == torch.bfloat16
    assert [c[0] for c in lib.calls] == ["ise_groupmin_two_level_mma"]
    p = GV.two_level_plan(nq, n, d, layout)
    assert p == T.mma_plan(nq, n, d, staged=64 if layout == "v2" else 0)
    args = lib.calls[0][1]
    # q, norms, x, gmin, smin, nq, n, d, layout, bq, dp, kc, gps, resident, smem, vec, stream
    assert args[:4] == (q.data_ptr(), norms.data_ptr(), x.data_ptr(), gmin.data_ptr())
    if layout != "v3":  # v3's (nsub, Q) buffer is transposed after the launch
        assert args[4] == smin.data_ptr()
    assert args[5:] == (nq, n, d, GV.LAYOUTS.index(layout), p.bq, p.dp, p.kc, p.gps,
                        int(p.resident), p.smem, T._vec_mma(q, x), 0)
    assert counts(GV.groupmin_two_level) == (1, 1, 0)


def test_cuda_core_route_only_when_forced(fake_cuda, monkeypatch):
    lib = fake_cuda()
    q, x, norms = inputs()
    monkeypatch.setattr(GV, "ROUTE", "cuda_core")
    GV.groupmin_width(q, x, norms, 64)
    GV.groupmin_two_level(q, x, norms, "v2")
    assert [c[0] for c in lib.calls] == ["ise_groupmin_width", "ise_groupmin_two_level"]
    nq, d = q.shape
    # ..., nq, n, d, group / layout, qt, vec, stream
    assert lib.calls[0][1][4:] == (nq, x.shape[0], d, 64, T._query_tile(nq, d * 4), 1, 0)
    assert lib.calls[1][1][5:] == (nq, x.shape[0], d, 1, T._query_tile(nq, d * 4), 1, 0)
    assert counts(GV.groupmin_width) == (1, 0, 1)
    assert counts(GV.groupmin_two_level) == (1, 0, 1)
    monkeypatch.setattr(GV, "ROUTE", "mma")
    GV.groupmin_width(q, x, norms, 64)
    assert lib.calls[-1][0] == "ise_groupmin_width_mma"
    assert counts(GV.groupmin_width) == (2, 1, 1)
    GV.reset_launch_counts()
    assert counts(GV.groupmin_width) == counts(GV.groupmin_two_level) == (0, 0, 0)


def test_unknown_route_raises(fake_cuda, monkeypatch):
    fake_cuda()
    q, x, norms = inputs()
    monkeypatch.setattr(GV, "ROUTE", "dp4a")
    with pytest.raises(ValueError, match="ROUTE"):
        GV.groupmin_width(q, x, norms, 128)
    assert counts(GV.groupmin_width) == (0, 0, 0)


@pytest.mark.parametrize("route", GV.ROUTES)
@pytest.mark.parametrize("kernel", ["width", "two_level"])
def test_failed_launch_raises_and_counts_nothing(fake_cuda, monkeypatch, route, kernel):
    lib = fake_cuda(rc=2)
    monkeypatch.setattr(GV, "ROUTE", route)
    q, x, norms = inputs()
    fn = GV.groupmin_width if kernel == "width" else GV.groupmin_two_level
    with pytest.raises(RuntimeError, match="fake error"):
        fn(q, x, norms, 32) if kernel == "width" else fn(q, x, norms, "v1")
    assert len(lib.calls) == 1
    assert counts(fn) == (0, 0, 0)


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_kernels, "library", no_library)
    q, x, norms = inputs()
    before = counts(GV.groupmin_width), counts(GV.groupmin_two_level)
    for route in GV.ROUTES:
        monkeypatch.setattr(GV, "ROUTE", route)
        for g in GV.WIDTHS:
            assert torch.equal(GV.groupmin_width(q, x, norms, g),
                               GV.groupmin_width_ref(q, x, norms, g))
        for lay in GV.LAYOUTS:
            gm, sm = GV.groupmin_two_level(q, x, norms, lay)
            rg, rs = GV.groupmin_two_level_ref(q, x, norms)
            assert torch.equal(gm, rg) and torch.equal(sm, rs)
    assert (counts(GV.groupmin_width), counts(GV.groupmin_two_level)) == before


# ---------------------------------------------------------------------------
# (b) v2's staging in the plan's shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,d", [(2048, 128), (4096, 128), *((bq, 128) for bq in T.MMA_BQ),
                                  (7, 130), (129, 128), (64, 2048)])
def test_v2_staging_fits_two_blocks_an_sm(nq, d):
    n = 10 ** 6
    p = GV.two_level_plan(nq, n, d, "v2")
    base = T.mma_plan(nq, n, d)
    assert (p.bq, p.gps, p.dp) == (base.bq, base.gps, base.dp)
    stage = p.bq * GV.V2_STAGED  # a run of 8 groups' four bf16 subgroup mins per query
    assert p.staged == GV.V2_STAGED == 64
    assert p.smem == T._groupmin_mma_smem(p.bq, nq, p.dp, p.kc, p.resident) + stage
    assert p.smem <= T._MMA_SMEM_TWO_BLOCKS
    # the widest k-chunk the plan tries that leaves room for the staging
    wider = {min(p.dp, kb // 2) for kb in T._MMA_KC_BYTES} - {p.kc}
    for k in (k for k in wider if k > p.kc):
        assert T._groupmin_mma_smem(p.bq, nq, p.dp, k, p.resident) + stage > \
            T._MMA_SMEM_TWO_BLOCKS
    for lay in ("v1", "v3"):
        assert GV.two_level_plan(nq, n, d, lay) == base


def test_v2_bench_point_plan():
    # bench.py's point: 8 KB of staging (128 queries x 32 subgroups x 2 B)
    # beside the resident tile leave production's plan as it is, two blocks
    # an SM (113 KB each at most)
    p = GV.two_level_plan(2048, 10 ** 6, 128, "v2")
    base = T.mma_plan(2048, 10 ** 6, 128)
    assert (p.bq, p.gps, p.resident, p.kc) == (base.bq, base.gps, base.resident, base.kc) == (
        128, 16, True, 128)
    assert p.smem - base.smem == 8192 and p.smem <= T._MMA_SMEM_TWO_BLOCKS


# ---------------------------------------------------------------------------
# (c) the output policies' epilogue, emulated
# ---------------------------------------------------------------------------


def warp_mins(q, x, norms, plan):
    """red as the kernel holds it when a group ends: for every 128-row group
    g, warp w along the rows (WN of them, 128 / WN contiguous rows each) and
    query r, the min of the warp's f32 scores, +inf past N. (ngroups, WN,
    Q)."""
    wn = T._MMA_WARPS // (2 if plan.bq >= 32 else 1)
    s = (norms[None, :] - 2.0 * (q.float() @ x.float().T)).numpy()
    ng = T.num_groups(x.shape[0])
    s = np.pad(s, ((0, 0), (0, ng * T.GROUP - s.shape[1])), constant_values=np.inf)
    return s.reshape(q.shape[0], ng, wn, T.GROUP // wn).min(3).transpose(1, 2, 0), wn


def emulate_width(red, wn, n, nq, group):
    """WidthMins<G>::group: i over PER * BQ, r = i % BQ, j = i / BQ, the
    fminf of warps j * E to j * E + E - 1, out[gg * nq + q]."""
    per = T.GROUP // group
    e = wn // per
    ng = -(-n // group)
    out = np.full(ng * nq, np.nan, np.float32)
    for g in range(red.shape[0]):
        for j in range(per):
            gg = g * per + j
            if gg >= ng:
                continue
            m = red[g, j * e]
            for w in range(1, e):
                m = np.fmin(m, red[g, j * e + w])
            out[gg * nq:(gg + 1) * nq] = m
    return out.reshape(ng, nq)


def emulate_two_level(red, wn, n, nq, layout, grid):
    """TwoLevelMins<L>::group over the blocks of ``grid`` (query tile,
    slice of groups): the group mins over all WN warps, each subgroup's
    over E = WN / 4, rounded to bf16; v2 keeps a run of RUN groups' in
    shared memory (NaN where nothing was kept) and writes the run at its
    last group or the slice's."""
    run, subs = 8, T.GROUP // GV.SUB
    e = wn // subs
    nsub = -(-n // GV.SUB)
    ng = red.shape[0]
    gmin = np.full((ng, nq), np.nan, np.float32)
    smin = np.full((nsub, nq) if layout == "v3" else (nq, nsub), np.nan, np.float32)
    q0s, q1s, g0s, g1s = (t.tolist() for t in grid.block_tiles(torch.arange(grid.grid)))
    for q0, q1, g0, g1 in zip(q0s, q1s, g0s, g1s):
        kept = np.full((q1 - q0, run * subs), np.nan, np.float32)
        for g in range(g0, g1):
            gl = g - g0
            m = red[g, 0, q0:q1]
            for w in range(1, wn):
                m = np.fmin(m, red[g, w, q0:q1])
            gmin[g, q0:q1] = m
            for s in range(subs):
                sg = g * subs + s
                if sg >= nsub:
                    continue
                m = red[g, s * e, q0:q1]
                for w in range(1, e):
                    m = np.fmin(m, red[g, s * e + w, q0:q1])
                v = torch.from_numpy(m).to(torch.bfloat16).float().numpy()
                if layout == "v1":
                    smin[q0:q1, sg] = v
                elif layout == "v2":
                    kept[:, (gl % run) * subs + s] = v
                else:
                    smin[sg, q0:q1] = v
            if layout == "v2" and (gl % run == run - 1 or g == g1 - 1):
                first = g - gl % run
                for j in range((g - first + 1) * subs):
                    if first * subs + j < nsub:
                        smin[q0:q1, first * subs + j] = kept[:, j]
    return gmin, (smin.T if layout == "v3" else smin)


@pytest.mark.parametrize("nq", [7, 64, 129])  # query tiles of 16 (WN = 8), 64 and 128 (WN = 4)
@pytest.mark.parametrize("n", [1, 33, 129, 700, 5000])
def test_policies_emulated_equal_the_plain_versions(nq, n):
    q, x, norms = inputs(nq, n, 32, seed=n + nq)
    plan = T.mma_plan(nq, n, 32)
    red, wn = warp_mins(q, x, norms, plan)
    assert wn == (8 if nq <= 16 else 4)
    for g in GV.WIDTHS:
        got = emulate_width(red, wn, n, nq, g)
        assert np.array_equal(got, GV.groupmin_width_ref(q, x, norms, g).numpy()), g
    want_g, want_s = GV.groupmin_two_level_ref(q, x, norms)
    assert np.array_equal(emulate_width(red, wn, n, nq, 128), want_g.numpy())
    # the plan's slices, and slices of 11 and 16 groups: v2's runs of 8 cut
    # at a slice's end
    for gps in sorted({plan.gps, 11, 16}):
        grid = T.SweepGrid(nq, n, plan.bq, min(gps, plan.ngroups))
        for lay in GV.LAYOUTS:
            gm, sm = emulate_two_level(red, wn, n, nq, lay, grid)
            assert np.array_equal(gm, want_g.numpy()), (lay, gps)
            assert np.array_equal(sm, want_s.float().numpy()), (lay, gps)

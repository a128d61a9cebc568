"""The phase-2 prototypes ``rescore_gather`` and ``rescore_cross`` on their
group route (image_search_engine_tpu_torch/ops/rescore_variants.py;
``rescore_grouped_kernel`` in ``csrc/rescore_variants.cu``), and the empty
batch and k = 0 on the flat two-phase search.

The kernels run only on the card, where ``chip_smoke.py`` phase 7 holds
them to their plain versions. Here:

  (a) an empty batch (k = 5) and k = 0 through the port's ``FlatIndex``
      against the JAX package's, for every store dtype and metric: float32
      distances and int32 ids of the reference's shapes, (0, 5) and (3, 0)
      (inputs: ``np.random.default_rng(0)``, 300 x 33 f32 rows); the plain
      versions at Q = 0; ``topk_twophase(..., with_certificate=True)`` at
      k = 0, where the certificate holds vacuously;
  (b) the block plan: a block per ``qb`` slots of the group order,
      emulated block for block over the plain ``group_order_ref``: every
      ordered slot in one block's range, ceil(Q t / qb) blocks, a group
      staged once per run of it in a range, so at most the distinct groups
      plus blocks - 1 stagings; each (slot, row) written once, equal to the
      plain version within 16 f32 ulps of the magnitudes summed; skewed
      lists (one group for every query, repeated groups, ids outside
      [0, ngroups), t = ngroups) among them; the plan's shared memory for
      every shape the wrapper takes;
  (c) the routing, with a fake kernel library: the slot order
      (``slot_order``: its shared-memory kernel where bins and order fit,
      else ``group_order``), then the group route's entry point with the
      plan's arguments; the slot route's entry point only when ``ROUTE`` is
      forced; launches per route; a failed launch raises and counts nothing.
"""

import contextlib

import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from image_search_engine_tpu.index.flat import FlatIndex as JaxFlatIndex
from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import rescore_variants as RV
from image_search_engine_tpu_torch.ops import topk as T

EPS32 = float(np.finfo(np.float32).eps)
GROUP = 128
SMEM_MAX = 232_448  # dynamic shared memory an H100 block may ask for


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# (a) the empty batch (F4) and k = 0 (F5)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).standard_normal((300, 33)).astype(np.float32)


@pytest.mark.parametrize("metric", ("l2", "ip", "cosine"))
@pytest.mark.parametrize("dtype", ("f32", "bf16", "int8"))
def test_empty_batch_and_k0_match_the_jax_flat_index(rows, dtype, metric):
    port = FlatIndex(metric, dtype=dtype, device="cpu").add(rows)
    ref = JaxFlatIndex(metric, dtype=dtype).add(rows)
    for q, k in ((rows[:0], 5), (rows[:3], 0)):
        pd, pi = port.search(q, k)
        jd, ji = ref.search(q, k)
        assert pd.shape == pi.shape == jd.shape == ji.shape == (q.shape[0], k)
        assert pd.dtype == jd.dtype == np.float32 and pi.dtype == ji.dtype == np.int32


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16, torch.int8))
def test_two_phase_search_at_k0_is_vacuously_certified(rows, dtype):
    x = torch.from_numpy(rows)
    scale = None
    if dtype == torch.int8:
        x, scale = T.quantize_int8(x)
    else:
        x = x.to(dtype)
    q = torch.from_numpy(rows[:3])
    d, i, cert = T.topk_twophase(q, x, 0, "l2", x_scale=scale, with_certificate=True)
    assert d.shape == i.shape == (3, 0) and d.dtype == torch.float32
    assert cert.dtype == torch.bool and cert.tolist() == [True] * 3
    d, i = T.topk_twophase_safe(q[:0], x, 5, "ip", x_scale=scale)
    assert d.shape == i.shape == (0, 5)


@pytest.mark.parametrize("fn", (RV.rescore_gather_ref, RV.rescore_cross_ref, RV.rescore_gather,
                                RV.rescore_cross), ids=lambda f: f.__name__)
def test_rescore_variants_take_an_empty_batch(fn):
    x = torch.randn(300, 33).to(torch.bfloat16)
    out = fn(x[:0], x, torch.zeros((0, 2), dtype=torch.int32))
    assert out.shape == (0, 2 * GROUP) and out.dtype == torch.float32
    ref = T.rescore_ref(x[:0], x, (x.float() ** 2).sum(1), torch.zeros((0, 3), dtype=torch.int32))
    assert ref.shape == (0, 3 * GROUP)


# ---------------------------------------------------------------------------
# (b) the block plan, emulated over group_order_ref
# ---------------------------------------------------------------------------


def block_runs(cand, n, qb):
    """The group route's blocks as the kernel walks them: per block, its
    ordered slots and its runs (slot positions of one valid group each)."""
    ng = T.num_groups(n)
    order = T.group_order_ref(cand, ng).order.numpy()
    groups = cand.reshape(-1).numpy()
    blocks = []
    for b in range(-(-order.size // qb)):
        sl = order[b * qb:(b + 1) * qb]
        g = groups[sl]
        valid = (g >= 0) & (g < ng)
        idx = np.flatnonzero(valid)
        assert idx.size == 0 or np.array_equal(idx, np.arange(idx[0], idx[-1] + 1))
        starts = [p for p in idx if p == idx[0] or g[p] != g[p - 1]]
        bounds = starts + [idx[-1] + 1] if idx.size else []
        blocks.append((sl, [list(range(a, z)) for a, z in zip(bounds, bounds[1:])]))
    return blocks


def emulate(q, x, cand, qb, gather):
    """The group route block for block in float64 over the bf16 values:
    (out (Q, t*128), writes per (slot, row), stagings, ranges per slot)."""
    nq, t = cand.shape
    n = x.shape[0]
    ng = T.num_groups(n)
    xd, qd = x.double().numpy(), q.double().numpy()
    groups = cand.reshape(-1).numpy()
    out = np.full((nq * t, GROUP), np.nan)
    writes = np.zeros((nq * t, GROUP), dtype=int)
    covered = np.zeros(nq * t, dtype=int)
    past = np.inf if gather else 0.0
    stagings = 0
    for sl, runs in block_runs(cand, n, qb):
        covered[sl] += 1
        for p, s in enumerate(sl):
            if not 0 <= groups[s] < ng:
                out[s], writes[s] = past, writes[s] + 1
        for run in runs:
            stagings += 1
            rows = groups[sl[run[0]]] * GROUP + np.arange(GROUP)
            inside = rows < n
            xs = xd[np.minimum(rows, n - 1)]  # the staged group, zeros past N
            xs[~inside] = 0.0
            xx = (xs * xs).sum(1)
            for p in run:
                s = sl[p]
                cross = xs @ qd[s // t]
                score = xx - 2.0 * cross if gather else cross
                out[s] = np.where(inside, score, past)
                writes[s] += 1
    return out.reshape(nq, t * GROUP), writes, stagings, covered


def make(seed, nq, n, d=64):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(nq, d, generator=g).to(torch.bfloat16),
            torch.randn(n, d, generator=g).to(torch.bfloat16))


def tol(q, x):
    norms = (x.double() ** 2).sum(1)
    return 16 * EPS32 * (float(norms.max()) + 2 * float(q.double().norm(dim=1).max())
                         * float(norms.max()) ** 0.5)


def candidates(kind, nq, n, t, seed):
    ng = T.num_groups(n)
    rng = np.random.default_rng(seed)
    if kind == "random":
        cand = rng.integers(0, ng, (nq, t))
        cand[:, 0] = ng - 1  # the ragged last group
    elif kind == "one group":
        cand = np.full((nq, t), ng // 2)
    elif kind == "repeats":
        cand = rng.integers(0, min(3, ng), (nq, t))
    elif kind == "outside":
        cand = rng.integers(0, ng, (nq, t))
        cand[:, 0] = -1
        cand[::2, -1] = ng + 3
    else:  # "all groups": t = ngroups, every group once in a random order a query
        cand = np.argsort(rng.random((nq, ng)), axis=1)
    return torch.from_numpy(cand.astype(np.int32))


CASES = [("random", 37, 3000, 5), ("one group", 50, 3000, 3), ("repeats", 21, 1000, 12),
         ("outside", 19, 3000, 4), ("all groups", 9, 1000, None), ("random", 1, 100, 1)]


@pytest.mark.parametrize("kind,nq,n,t", CASES, ids=[c[0] + f"-{c[1]}" for c in CASES])
@pytest.mark.parametrize("qb", RV.QBS)
def test_group_route_emulated_block_for_block(kind, nq, n, t, qb):
    q, x = make(nq + n, nq, n)
    cand = candidates(kind, nq, n, t, seed=qb)
    t = cand.shape[1]
    plan = RV.grouped_plan(nq, t, x.shape[1], qb, True)
    assert plan.blocks == -(-nq * t // qb)
    valid = cand[(cand >= 0) & (cand < T.num_groups(n))]
    distinct = torch.unique(valid).numel()
    for gather, ref in ((True, RV.rescore_gather_ref), (False, RV.rescore_cross_ref)):
        out, writes, stagings, covered = emulate(q, x, cand, qb, gather)
        assert (covered == 1).all() and (writes == 1).all()
        assert stagings <= distinct + plan.blocks - 1
        want = ref(q, x, cand).double().numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(out[fin], want[fin], rtol=0, atol=tol(q, x))
        if not gather:
            assert (out[~np.isfinite(RV.rescore_gather_ref(q, x, cand).numpy())] == 0).all()
    if kind == "one group":  # every block stages the one group once
        assert stagings == plan.blocks


@settings(max_examples=60, deadline=None)
@given(nq=st.integers(0, 40), t=st.integers(1, 9), n=st.integers(1, 1200),
       qb=st.sampled_from(RV.QBS), skew=st.floats(0, 1), seed=st.integers(0, 2 ** 16))
def test_block_plan_arithmetic(nq, t, n, qb, skew, seed):
    """Every ordered slot in exactly one block's range, ceil(Q t / qb)
    blocks, at most distinct groups + blocks - 1 stagings, for lists where
    a share ``skew`` of the slots picked one group."""
    ng = T.num_groups(n)
    t = min(t, ng)
    rng = np.random.default_rng(seed)
    cand = rng.integers(-1, ng + 2, (nq, t))
    cand[rng.random((nq, t)) < skew] = ng - 1
    cand = torch.from_numpy(cand.astype(np.int32))
    blocks = block_runs(cand, n, qb)
    assert len(blocks) == RV.grouped_plan(nq, t, 64, qb, True).blocks == -(-nq * t // qb)
    slots = np.concatenate([sl for sl, _ in blocks]) if blocks else np.zeros(0, int)
    assert np.array_equal(np.sort(slots), np.arange(nq * t))
    assert all(len(sl) == qb for sl, _ in blocks[:-1])
    valid = cand[(cand >= 0) & (cand < ng)]
    stagings = sum(len(runs) for _, runs in blocks)
    assert stagings <= torch.unique(valid).numel() + max(len(blocks) - 1, 0)


@pytest.mark.parametrize("qb", RV.QBS)
def test_plan_shared_memory_fits_every_shape_the_wrapper_takes(qb):
    d_max = T._SMEM_BYTES // (qb * 4)  # the wrapper's limit: qb f32 query rows
    for d in (1, 8, 33, 128, 130, 1040, d_max):
        p = RV.grouped_plan(5, 3, d, qb, d % 8 == 0)
        dp = -(-d // 16) * 16
        assert p.smem == 1024 + p.stages * 32768 + qb * (2 * dp + 16) <= SMEM_MAX
        assert p.stages == RV.GROUPED_STAGES[qb] and p.tma == (d % 8 == 0)


# ---------------------------------------------------------------------------
# (c) routing on a fake kernel library
# ---------------------------------------------------------------------------


class FakeLibrary:
    """Records each entry point's arguments; returns rc[name] (default 0)."""

    def __init__(self, rc=None):
        self.rc = rc or {}
        self.calls = []

    def ise_error_string(self, err):
        return b"fake error"

    def __getattr__(self, name):
        if not name.startswith("ise_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.rc.get(name, 0)
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    """A fake kernel library behind the wrappers (and group_order), which
    take CPU tensors for CUDA ones; launch counts start at 0 and are put
    back after."""
    keep = {fn: {a: getattr(fn, a) for a in ("launches", "group_launches", "slot_launches")}
            for fn in RV.KERNELS}
    keep_order = T.group_order.launches, RV.slot_order.launches
    RV.reset_launch_counts()
    T.group_order.launches = 0

    def install(rc=None):
        lib = FakeLibrary(rc)
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        for mod in (RV, T):
            monkeypatch.setattr(mod, "_on_cuda", lambda *ts: True)
            monkeypatch.setattr(mod, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        return lib
    yield install
    for fn, attrs in keep.items():
        for a, v in attrs.items():
            setattr(fn, a, v)
    T.group_order.launches, RV.slot_order.launches = keep_order


def counts(fn):
    return fn.launches, fn.group_launches, fn.slot_launches


@pytest.mark.parametrize("d", (128, 130))
@pytest.mark.parametrize("qb", RV.QBS)
@pytest.mark.parametrize("fn", RV.KERNELS, ids=lambda f: f.__name__)
def test_wrapper_orders_the_slots_then_launches_the_group_route(fake_cuda, fn, qb, d):
    lib = fake_cuda()
    q, x = make(0, 19, 1000, d)
    cand = candidates("random", 19, 1000, 6, seed=1)
    out = fn(q, x, cand, qb=qb)
    assert out.shape == (19, 6 * GROUP) and out.dtype == torch.float32
    assert [c[0] for c in lib.calls] == ["ise_rescore_order", f"ise_{fn.__name__}_grouped"]
    order_args, args = lib.calls[0][1], lib.calls[1][1]
    # cand, order, slots, ngroups, smem (bins and order), stream
    assert order_args[0] == cand.data_ptr() and order_args[2:] == (19 * 6, 8, (10 + 114) * 4, 0)
    p = RV.grouped_plan(19, 6, d, qb, d == 128)
    # q, x, cand, order, out, nq, n, d, t, qb, stages, smem, tma, stream
    assert args == (q.data_ptr(), x.data_ptr(), cand.data_ptr(), order_args[1], out.data_ptr(),
                    19, 1000, d, 6, qb, p.stages, p.smem, int(d == 128), 0)
    assert counts(fn) == (1, 1, 0) and RV.slot_order.launches == 1
    assert T.group_order.launches == 0


def test_slot_order_beyond_shared_memory_is_group_order(fake_cuda):
    """Bins and order over ORDER_SMEM_BYTES: production's group_order (its
    bins in device memory) orders the slots; at the limit, the kernel."""
    lib = fake_cuda()
    ng = 7813  # bench.py's 1M rows
    for nq, name in ((4170, "ise_rescore_order"), (4171, "ise_group_order")):
        cand = torch.zeros((nq, 12), dtype=torch.int32)
        order = RV.slot_order(cand, ng)
        assert lib.calls[-1][0] == name and order.shape == (nq * 12,)
        assert ((ng + 2 + nq * 12) * 4 <= RV.ORDER_SMEM_BYTES) == (nq == 4170)
    assert RV.slot_order.launches == T.group_order.launches == 1


def test_slot_route_only_when_forced(fake_cuda, monkeypatch):
    lib = fake_cuda()
    q, x = make(1, 7, 600)
    cand = candidates("random", 7, 600, 3, seed=2)
    monkeypatch.setattr(RV, "ROUTE", "slot")
    g = RV.rescore_gather(q, x, cand, qb=16)
    c = RV.rescore_cross(q, x, cand)
    assert [n for n, _ in lib.calls] == ["ise_rescore_gather", "ise_rescore_cross"]
    # q, x, cand, out, nq, n, d, t, qb, vec, stream
    assert lib.calls[0][1] == (q.data_ptr(), x.data_ptr(), cand.data_ptr(), g.data_ptr(), 7, 600,
                               64, 3, 16, T._vec(x), 0)
    assert lib.calls[1][1][3] == c.data_ptr() and lib.calls[1][1][8] == 8
    assert counts(RV.rescore_gather) == counts(RV.rescore_cross) == (1, 0, 1)
    assert T.group_order.launches == 0
    monkeypatch.setattr(RV, "ROUTE", "nope")
    with pytest.raises(ValueError, match="ROUTE"):
        RV.rescore_gather(q, x, cand)


@pytest.mark.parametrize("failing", ("ise_rescore_order", "ise_rescore_gather_grouped"))
def test_failed_launch_raises_and_counts_nothing(fake_cuda, failing):
    lib = fake_cuda({failing: 700})
    q, x = make(2, 5, 500)
    with pytest.raises(RuntimeError, match="launch failed"):
        RV.rescore_gather(q, x, candidates("random", 5, 500, 2, seed=3))
    assert lib.calls[-1][0] == failing
    assert counts(RV.rescore_gather) == (0, 0, 0)


def test_cpu_tensors_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")
    monkeypatch.setattr(_kernels, "library", no_library)
    q, x = make(3, 4, 400)
    cand = candidates("outside", 4, 400, 2, seed=4)
    for route in RV.ROUTES:
        monkeypatch.setattr(RV, "ROUTE", route)
        assert torch.equal(RV.rescore_gather(q, x, cand), RV.rescore_gather_ref(q, x, cand))
        assert torch.equal(RV.rescore_cross(q, x, cand), RV.rescore_cross_ref(q, x, cand))

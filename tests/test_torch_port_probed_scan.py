"""The IVF probed scan's two routes (image_search_engine_tpu_torch/ops/ivf.py
``probed_scan``, ``probed_scan_plan``, ``probed_scan_ref``;
``csrc/ivf_probed_scan.cu``).

The kernels run only on the card, where ``chip_smoke.py`` holds both routes
to each other bit for bit and to ``probed_scan_ref`` within ``score_tol``.
Here:

  (a) the plan as a pure function: slot by slot for a served query and the
      IVF-PQ batch of 64, bucket by bucket at the JAX package's batched-IVF
      point (Q = 256 and 1024 over 1M x 128, nlist 1024); the kernel and
      its tile by the row width;
  (b) the bucket route's grouping, block for block in numpy: the slots
      ordered by ``group_order``'s plain version, a block per bin that has
      slots (as many blocks as slots or bins, the fewer), each (bin, row
      slice) block's warps' tasks (2 slots against 8 narrow rows or 1 wide
      one);
      every (slot, row) written exactly once, with slots that share a
      bucket, probe ids < 0 and >= nbuckets (+inf) and pad slots (+inf
      norms), the scores equal to ``probed_scan_ref``'s; a task's
      butterflies folded into one transposed reduction, each f32 sum
      bit-equal to the butterfly's;
  (c) the routing, with a fake kernel library: each route reaches its entry
      points with the plan's arguments and its own launch counter; a failed
      launch raises; CPU tensors run ``probed_scan_ref``; ``chip_smoke``'s
      forcing of either route plans it as the wrapper would;
  (d) the port's batched ``ivf_probed_topk`` against the JAX package's (its
      Pallas probed scan and select in interpret mode) where buckets are
      shared: Q = 128 over 8 buckets, 4 probed, d = 16.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from image_search_engine_tpu.ops.ivf_pallas import ivf_probed_topk as jax_probed_topk
from image_search_engine_tpu_torch.ops import ivf as IV
from image_search_engine_tpu_torch.ops import topk as T
from test_torch_port_groupmin_tf32 import fake_cuda  # noqa: F401  (a fixture)

EPS32 = float(np.finfo(np.float32).eps)
TILE_Q = 2  # slots a warp of the tile kernel scores at once (csrc/ivf_probed_scan.cu)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def table(rng, nb=8, cap=50, d=16, dtype=np.float32):
    """A packed (nb, cap, d) table with pad slots (+inf norms, finite rows)
    past each bucket's fill, its norms, and bucket centroids."""
    packed = rng.standard_normal((nb, cap, d)).astype(np.float32)
    fill = rng.integers(cap // 3, cap + 1, nb)
    norms = (packed.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    lists = np.arange(nb * cap, dtype=np.int32).reshape(nb, cap)
    for b in range(nb):
        norms[b, fill[b]:] = np.inf
        lists[b, fill[b]:] = -1
    return packed, norms, lists, packed.mean(1)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,nprobe,nb,cap,d,isz,route", [
    (1, 6, 1381, 1272, 2048, 2, "slot"),      # a served IVF-PQ query
    (64, 6, 1381, 1272, 2048, 2, "slot"),     # the IVF-PQ batch
    (115, 6, 1381, 1272, 2048, 2, "slot"),    # 690 slots, below half the buckets
    (116, 6, 1381, 1272, 2048, 2, "bucket"),  # 696 slots, at least half
    (128, 6, 1381, 1272, 2048, 2, "bucket"),  # the IVF-PQ batch above the crossing
    (1, 6, 1407, 1272, 128, 4, "slot"),       # the batched-IVF point, Q = 1
    (32, 6, 1407, 1272, 128, 4, "slot"),      # Q = 32, below the crossing
    (64, 6, 1407, 1272, 128, 4, "bucket"),    # Q = 64, above it
    (256, 6, 1407, 1272, 128, 4, "bucket"),
    (1024, 6, 1407, 1272, 128, 4, "bucket"),
    (1024, 6, 1407, 1272, 128, 2, "bucket"),
    (1024, 6, 1100, 1272, 2048, 4, "bucket"),
    (42, 6, 1100, 1272, 128, 4, "slot"),      # 252 slots, below the narrow floor of 256
    (43, 6, 1100, 1272, 128, 4, "bucket"),    # 258 slots
    (99, 4, 2000, 1272, 128, 4, "slot"),      # 396 slots, below a fifth of the buckets
    (101, 4, 2000, 1272, 128, 4, "bucket"),   # 404 slots
    (85, 6, 1000, 1272, 2048, 2, "slot"),     # 510 slots, below the wide floor of 512
    (86, 6, 1000, 1272, 2048, 2, "bucket"),   # 516 slots
    (64, 6, 1000, 1272, 256, 4, "slot"),      # 1024-byte rows: the wide rule, 384 < 512
    (2, 4, 8, 50, 16, 4, "slot"),
    (64, 4, 8, 50, 16, 4, "bucket"),
    (1, 300, 8, 50, 16, 4, "slot"),           # one query's probes share no bucket
])
def test_the_plan_chooses_a_route(nq, nprobe, nb, cap, d, isz, route):
    """The route by the slots' count against the buckets' and the row
    width; the kernel and its tile by the route, the row width and Q: the
    row kernel for the slot route over rows wider than 512 bytes or for one
    query, else tiles of at least a row a warp, within the shared memory, a
    multiple of the rows a warp scores at once (8 rows of up to 1024 bytes,
    1 wider)."""
    plan = IV.probed_scan_plan(nq, nprobe, nb, cap, d, isz)
    assert plan.route == route
    row = d * isz
    if route == "slot" and (row > IV._SLOT_TILE_ROW_BYTES or nq == 1):  # the row kernel
        assert (plan.rows, plan.r, plan.smem) == (0, 1, 0)
        return
    other = "slot" if route == "bucket" else "bucket"
    if row <= IV._SLOT_TILE_ROW_BYTES:  # one tile for both routes beyond one query
        assert replace(IV.probed_scan_plan(max(nq, 2), nprobe, nb, cap, d, isz, route=other),
                       route=route) == plan
    assert plan.r == (IV._TILE_R if row <= IV._NARROW_ROW_BYTES else 1)
    assert 1 <= plan.rows <= min(cap, IV._TILE_MAX_ROWS)
    assert plan.rows % plan.r == 0 or plan.rows == cap
    assert plan.rows >= min(IV._TILE_MIN_ROWS, cap)
    assert plan.rows * row <= max(IV._TILE_SMEM_TARGET, IV._TILE_MIN_ROWS * row)
    assert plan.rows * row + 4 * plan.rows <= plan.smem <= T._SMEM_BYTES


def test_the_plan_raises_on_shapes_it_cannot_take():
    with pytest.raises(ValueError):
        IV.probed_scan_plan(0, 4, 8, 50, 16, 4)
    with pytest.raises(ValueError):
        IV.probed_scan_plan(4, 4, 8, 50, 16, 4, route="row")


@pytest.mark.parametrize("route", ["slot", "bucket"])
@pytest.mark.parametrize("d,isz", [(2048, 2), (128, 4)])
def test_chip_smoke_forces_either_route(route, d, isz):
    """chip_smoke.scan_route, which times both routes on the card, plans
    each as the wrapper would for a batch that takes it: the slot route's
    kernel by Q and the row width, the bucket route's tile by the width."""
    for nq in (1, 64):
        want = IV.probed_scan_plan(nq, 6, 1381, 1272, d, isz, route=route)
        with chip_smoke.scan_route(route):
            assert IV.probed_scan_plan(nq, 6, 1381, 1272, d, isz) == want
        assert want.route == route
    assert IV.probed_scan_plan(1, 6, 1381, 1272, d, isz).route == "slot"


# ---------------------------------------------------------------------------
# (b) the bucket route's grouping in numpy
# ---------------------------------------------------------------------------


def bucket_route_model(q, packed, norms, probe, rows, r):
    """probed_scan_tile_kernel on the bucket route, block for block: group g
    of min(slots, nbuckets + 2) is the g-th bin that has slots (ids < 0,
    each bucket, ids >= nbuckets: ``group_order``'s live list), row slices
    of ``rows``, each warp's (2-slot, r-row) tasks. Returns (scores, writes
    per (slot, row))."""
    nq, nprobe = probe.shape
    nb, cap, _ = packed.shape
    order, ends, live = (t.numpy() for t in T.group_order_ref(torch.from_numpy(probe), nb))
    out = np.full((nq * nprobe, cap), np.nan, np.float64)
    writes = np.zeros((nq * nprobe, cap), np.int64)
    nslices = -(-cap // rows)
    for blk in range(min(nq * nprobe, nb + 2) * nslices):
        g, s = divmod(blk, nslices)
        if g >= live[0]:
            continue  # past the last bin that has slots
        b = live[1 + g]
        start, end = (0 if b == 0 else ends[b - 1]), ends[b]
        assert start < end
        r0 = s * rows
        nr = min(cap - r0, rows)
        slots = order[start:end]
        scored = 0 < b <= nb  # a bucket of the table, not a bad id's bin
        if not scored:
            pairs = [(i // nr, i % nr) for i in range(len(slots) * nr)]
        else:
            groups = -(-nr // r)
            pairs = []
            for task in range(-(-len(slots) // TILE_Q) * groups):
                j0, t = task // groups * TILE_Q, task % groups
                for pair in range(TILE_Q * r):  # the lanes that write
                    j, i = j0 + pair // r, t * r + pair % r
                    if j < len(slots) and i < nr:
                        pairs.append((j, i))
        for j, i in pairs:
            slot = slots[j]
            out[slot, r0 + i] = (norms[b - 1, r0 + i] - 2.0 * (
                packed[b - 1, r0 + i].astype(np.float64) @ q[slot // nprobe].astype(np.float64))
                if scored else np.inf)
            writes[slot, r0 + i] += 1
    return out.reshape(nq, nprobe * cap), writes


@pytest.mark.parametrize("nq", [32, 2], ids=["more_slots_than_bins", "fewer_slots_than_bins"])
@pytest.mark.parametrize("rows,r", [(8, 8), (16, 8), (48, 8), (8, 1), (7, 1)])
def test_the_bucket_route_scores_each_slot_row_once(rows, r, nq):
    """Over 8 buckets (10 bins): 128 slots, or 8 slots (fewer blocks than
    bins); probe ids < 0 and >= nbuckets, and slots sharing buckets."""
    rng = np.random.default_rng(rows)
    packed, norms, _, _ = table(rng)
    nprobe = 4
    probe = rng.integers(0, 8, (nq, nprobe)).astype(np.int32)
    probe[0, 1] = probe[1, 0] = -1
    probe[1, 2] = 8  # >= nbuckets
    probe[0, 3] = probe[1, 3]  # a shared bucket
    q = rng.standard_normal((nq, 16)).astype(np.float32)
    out, writes = bucket_route_model(q, packed, norms, probe, rows, r)
    assert (writes == 1).all()
    ref = IV.probed_scan_ref(*map(torch.from_numpy, (q, packed, norms, probe))).numpy()
    cap = packed.shape[1]
    assert np.isinf(out[0, cap:2 * cap]).all() and np.isinf(out[1, 2 * cap:3 * cap]).all()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))  # bad ids and pad slots
    fin = np.isfinite(ref)
    scale = float(norms[np.isfinite(norms)].max() + 2 * np.linalg.norm(q, axis=1).max()
                  * np.sqrt(norms[np.isfinite(norms)].max()))
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0, atol=16 * EPS32 * scale)


def butterfly(parts: np.ndarray) -> np.ndarray:
    """row_dot's reduction of (32 lanes, rows) f32 partial sums: at offsets
    16, 8, 4, 2, 1 every lane adds its partner's value to its own. Returns
    lane 0's sums (every lane ends with the same bits)."""
    acc = parts.copy()
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[np.arange(32) ^ off]
    assert (acc == acc[0]).all()
    return acc[0]


def fold_sums(parts: np.ndarray) -> np.ndarray:
    """FoldSums<R, 16> in csrc/ivf_probed_scan.cu: while a lane holds n > 1
    sums it keeps the half its bit ``off`` selects and adds its partner's
    value of each kept row (the partner sent it); then the butterfly on the
    last. Returns each row's sum from the lane that ends with it (lane
    row << (5 - log2 R))."""
    acc = parts.copy()
    n = acc.shape[1]
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        partner = lanes ^ off
        if n > 1:
            upper = (lanes & off) != 0
            keep = np.where(upper[:, None], acc[:, n // 2:n], acc[:, :n // 2])
            send = np.where(upper[:, None], acc[:, :n // 2], acc[:, n // 2:n])
            acc[:, :n // 2] = keep + send[partner]
            n //= 2
        else:
            acc[:, 0] = acc[:, 0] + acc[partner, 0]
    shift = 5 - (parts.shape[1].bit_length() - 1)
    return np.array([acc[r << shift, 0] for r in range(parts.shape[1])], np.float32)


@pytest.mark.parametrize("rows", [1, TILE_Q, 4, 8, TILE_Q * IV._TILE_R, 32])
def test_the_folded_reduction_has_the_butterfly_s_bits(rows):
    """The bucket route folds its tile's butterflies (rows x queries) into
    one transposed reduction; each sum adds the same pairs in the same tree,
    so its f32 bits equal row_dot's (here over partial sums whose additions
    round at every step)."""
    rng = np.random.default_rng(rows)
    for _ in range(50):
        parts = (rng.standard_normal((32, rows)) * 10.0 ** rng.integers(-3, 4, (32, rows))
                 ).astype(np.float32)
        want = np.array([butterfly(parts[:, [r]])[0] for r in range(rows)], np.float32)
        assert np.array_equal(fold_sums(parts).view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# (c) routing
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_ivf(fake_cuda, monkeypatch):  # noqa: F811
    def install(rc=0):
        lib = fake_cuda(rc)
        monkeypatch.setattr(IV, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(IV, "_stream", lambda t: 0)
        return lib
    return install


@pytest.mark.parametrize("nq,dtype,d,entries", [
    (1, torch.bfloat16, 16, ["ise_probed_scan"]),
    (32, torch.float32, 16, ["ise_probed_scan"]),  # 128 slots: the slot route's tile kernel
    (1, torch.bfloat16, 1024, ["ise_probed_scan"]),  # wide rows: the row kernel
    (200, torch.float32, 16, ["ise_group_order", "ise_probed_scan_bucket"]),
    (200, torch.bfloat16, 16, ["ise_group_order", "ise_probed_scan_bucket"]),
    (200, torch.float32, 512, ["ise_group_order", "ise_probed_scan_bucket"]),
])
def test_each_route_reaches_its_entry_point(fake_ivf, nq, dtype, d, entries):
    lib = fake_ivf()
    rng = np.random.default_rng(nq)
    packed, norms, _, _ = table(rng, d=d)
    nprobe, (nb, cap, d) = 4, packed.shape
    probe = torch.from_numpy(rng.integers(0, nb, (nq, nprobe)).astype(np.int32))
    IV.probed_scan.launches = IV.probed_scan.slot_launches = IV.probed_scan.bucket_launches = 0
    T.group_order.launches = 0
    out = IV.probed_scan(torch.zeros(nq, d, dtype=dtype), torch.from_numpy(packed).to(dtype),
                         torch.from_numpy(norms), probe)
    assert out.shape == (nq, nprobe * cap)
    assert [c[0] for c in lib.calls] == entries
    args = lib.calls[-1][1]
    plan = IV.probed_scan_plan(nq, nprobe, nb, cap, d, out.new_empty(0, dtype=dtype).element_size())
    bucket = plan.route == "bucket"
    assert args[0] == T._DTYPE_CODES[dtype]
    if bucket:
        assert args[9:14] == (nq, nprobe, nb, cap, d)
        assert args[15:18] == (plan.rows, plan.r, plan.smem) and plan.rows > 0
        assert lib.calls[0][1][4:6] == (nq * nprobe, nb)  # group_order: slots, buckets
    else:
        assert args[6:11] == (nq, nprobe, nb, cap, d)
        assert args[12:15] == (plan.rows, plan.r, plan.smem)
    assert (IV.probed_scan.launches, IV.probed_scan.slot_launches,
            IV.probed_scan.bucket_launches, T.group_order.launches) == (
        1, int(not bucket), int(bucket), int(bucket))


@pytest.mark.parametrize("nq,what", [(1, "probed_scan"), (200, "group_order")])
def test_a_failed_launch_raises(fake_ivf, nq, what):
    fake_ivf(rc=1)
    packed, norms, _, _ = table(np.random.default_rng(0))
    probe = torch.zeros(nq, 4, dtype=torch.int32)
    with pytest.raises(RuntimeError, match=what):
        IV.probed_scan(torch.zeros(nq, 16), torch.from_numpy(packed), torch.from_numpy(norms),
                       probe)


@pytest.mark.parametrize("nq", [1, 200])
def test_the_cpu_wrapper_runs_the_plain_version(nq):
    rng = np.random.default_rng(7)
    packed, norms, _, _ = table(rng)
    probe = rng.integers(-1, 9, (nq, 4)).astype(np.int32)
    args = [torch.from_numpy(a) for a in
            (rng.standard_normal((nq, 16)).astype(np.float32), packed, norms, probe)]
    IV.probed_scan.launches = 0
    got = IV.probed_scan(*args)
    assert IV.probed_scan.launches == 0
    assert torch.equal(got, IV.probed_scan_ref(*args))


# ---------------------------------------------------------------------------
# (d) the batched probed top-k against the JAX package
# ---------------------------------------------------------------------------


def test_the_batched_probed_topk_equals_the_jax_kernel():
    """Q = 128 queries over 8 buckets of cap 50 (pad slots included), 4
    probed each, k = 10: 512 slots share 8 buckets, a batch the bucket route
    takes on the card. ok flags and ids equal; distances within 16 f32 ulps
    of the magnitudes that cancel (both sum 16 f32 products in other
    orders)."""
    rng = np.random.default_rng(32)
    packed, norms, lists, bc = table(rng)
    q = (packed[rng.integers(0, 8, 128), rng.integers(0, 16, 128)]
         + 0.3 * rng.standard_normal((128, 16))).astype(np.float32)
    assert IV.probed_scan_plan(128, 4, 8, 50, 16, 4).route == "bucket"
    pd, pi, pok = IV.ivf_probed_topk(*map(torch.from_numpy, (q, bc, packed, norms, lists)), 10,
                                     4)
    jd, ji, jok = jax_probed_topk(*map(jnp.asarray, (q, bc, packed, norms, lists)), 10, 4,
                                  interpret=True)
    pok, jok = pok.numpy(), np.asarray(jok)
    np.testing.assert_array_equal(pok, jok)
    assert pok.all()
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    xm = float(np.sqrt(norms[np.isfinite(norms)].max()))
    qm = float(np.linalg.norm(q, axis=1).max())
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=16 * EPS32 * (xm + qm) ** 2)

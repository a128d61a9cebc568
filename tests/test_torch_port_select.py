"""The candidate select (image_search_engine_tpu_torch/ops/topk.py
``select_topt``, ``select_plan``, ``select_topt_ref``; ``csrc/select_topt.cu``).

The radix-select kernel runs only on the card, where ``chip_smoke.py`` holds
it to ``select_topt_ref`` bit for bit over a sweep of shapes and rows. Here:

  (a) the host-side plan as pure functions: the radix select for every t,
      its sort of the selected entries chosen on t (counting up to
      ``SELECT_RANK_MAX_T``, a bitonic network in shared memory up to
      ``SELECT_SHARED_SORT_MAX_T``, a radix sort in a global scratch
      beyond); a row split over blocks only for batches of fewer rows than
      SMs, into non-empty slices that cover the row, each at least t
      entries, whose candidates fit the merge; the staging threshold;
  (b) the routing, with a fake kernel library: the radix select reaches its
      entry point with the plan's arguments (scratch for split rows and for
      the global sort) for every t, and the extract-min kernel only
      through ``chip_smoke.select_route``, each with its own launch counter;
      a failed launch raises;
  (c) the kernel's algorithm, step for step in numpy (the key transform,
      the digit passes from the first bit the entries' keys do not share,
      the stop when a bin holds exactly the entries still wanted, the
      position digits among tied keys, the compaction and the sort: by
      counting, by the bitonic network over the pairs padded to a power of
      two, or compacted in position order and radix-sorted by key digits
      with the kernel's per-warp offsets; first over a sample of every
      stride-th entry, then over the entries at or below the sample's t-th
      pair, or over the whole row when they overflow the scratch or t is
      too large to sample; a split row's slices selected in any order and
      merged by their positions): equal to a numpy lexsort bit for bit,
      -0.0 kept, on random, tie-heavy, +-0.0, +inf and NaN rows, with t =
      1, W - 1 and W and t beyond 256 (257, 300, 1000, 4096, W - 1 at W up
      to 65,536), and a number of digit passes that does not grow with t;
  (d) ``select_topt_ref`` against the JAX ``_select_topt`` (interpret mode,
      W = 16) on tie-heavy and +inf rows, t = 1 and t = W - 1 (ids at
      +inf values excepted: there the JAX kernel repeats id 0), and against
      a float64 numpy lexsort, also on rows that mix -0.0 and +0.0 (against
      the lexsort only: XLA's ``min`` may return either zero's sign); the
      port's ``ivf_probed_topk`` at k = 300 against the JAX one (its Pallas
      select in interpret mode) on a tiny IVF.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from image_search_engine_tpu.ops.ivf_pallas import ivf_probed_topk as jax_probed_topk
from image_search_engine_tpu.ops.topk_pallas import _select_topt as jax_select_topt
from image_search_engine_tpu_torch.ops import ivf as IV
from image_search_engine_tpu_torch.ops import topk as T
from test_torch_port_groupmin_tf32 import fake_cuda  # noqa: F401  (a fixture)

SMS = 132


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def lexsort_ref(row: np.ndarray, t: int):
    """The t smallest of a row by (value, position), numpy float64; NaN last."""
    order = np.lexsort((np.arange(row.size), row.astype(np.float64)))[:t]
    return row[order], order.astype(np.int32)


def rows_of(kind: str, nq: int, w: int, rng) -> np.ndarray:
    if kind == "random":
        return rng.standard_normal((nq, w)).astype(np.float32)
    if kind == "ties":  # a few levels
        return rng.integers(-2, 2, (nq, w)).astype(np.float32)
    if kind == "zeros":  # -0.0 and +0.0 mixed with a few other values
        v = np.where(rng.random((nq, w)) < 0.5, np.float32(-0.0), np.float32(0.0))
        return np.where(rng.random((nq, w)) < 0.1, rng.standard_normal((nq, w)), v).astype(
            np.float32)
    if kind == "inf":  # IVF pad slots: fewer finite entries than t in some rows
        v = rng.standard_normal((nq, w)).astype(np.float32)
        v[rng.random((nq, w)) < 0.8] = np.inf
        v[0] = np.inf
        return v
    if kind == "nan":
        v = rng.standard_normal((nq, w)).astype(np.float32)
        v[rng.random((nq, w)) < 0.05] = np.nan
        return v
    raise ValueError(kind)


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a) & np.isnan(b)
    return bool(np.array_equal(a.view(np.uint32)[~nan], b.view(np.uint32)[~nan])
                and np.array_equal(np.isnan(a), np.isnan(b)))


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,w,t", [
    (1, 7813, 24), (1, 7813, 160), (2, 7813, 12), (64, 7813, 24), (131, 7813, 24),
    (4096, 7813, 12), (1, 65536, 256), (1, 7632, 20), (64, 7632, 64), (1, 1, 1),
    (1, 31, 30), (2, 33, 33), (1, 2047, 256), (1, 1024, 24), (4096, 65536, 160),
    (1, 7813, 257), (1, 7813, 300), (64, 7813, 300), (1, 7813, 1000), (1, 65536, 4096),
    (1, 65536, 65535), (4096, 7813, 4096),
])
def test_radix_plan_covers_each_row_once(nq, w, t):
    plan = T.select_plan(nq, w, t, SMS)
    assert plan.route == "radix" and plan.sort == T.select_sort(t)
    assert plan.split * plan.slice >= w > (plan.split - 1) * plan.slice  # no empty slice
    if 4 * nq > SMS or w < 2 * T._SELECT_SPLIT_MIN_SLICE:
        assert plan.split == 1
    if plan.split > 1:
        assert plan.slice >= max(t, T._SELECT_SPLIT_MIN_SLICE)
        assert plan.split <= T._SELECT_SPLIT_MAX
        assert plan.split * t <= T._SELECT_MERGE_MAX
        assert nq * plan.split <= 2 * SMS  # about a block an SM
    assert plan.staged == (plan.slice <= T.SELECT_STAGE_MAX)


def test_small_batches_split_their_rows():
    assert T.select_plan(1, 7813, 24, SMS).split == 7  # 1,117-entry slices
    assert T.select_plan(33, 7813, 24, SMS).split == 4
    assert T.select_plan(34, 7813, 24, SMS).split == 1
    assert T.select_plan(1, 65536, 24, SMS).split == T._SELECT_SPLIT_MAX
    assert T.select_plan(1, 65536, 256, SMS).split == 4  # the merge's 1,024 candidates
    assert T.select_plan(1, 7813, 300, SMS).split == 3
    assert T.select_plan(1, 7813, 513, SMS).split == 1
    assert not T.select_plan(4096, 65536, 24, SMS).staged


@pytest.mark.parametrize("n,t,stride", [(7813, 12, 8), (7813, 24, 8), (1117, 24, 8),
                                        (7813, 52, 8), (7813, 160, 3), (1117, 160, 3),
                                        (7813, 256, 2), (1023, 256, 1), (1024, 256, 2),
                                        (191, 12, 1), (192, 12, 8), (32, 24, 1), (1, 1, 1)])
def test_the_sample_stride(n, t, stride):
    """Every stride-th entry, at least 2t of them, about stride * t let
    through, within half the scratch."""
    assert T.select_sample_stride(n, t) == stride
    if stride > 1:
        assert n // stride >= 2 * t and stride * t <= T._SELECT_CAND_MAX // 2


@pytest.mark.parametrize("t,sort", [(1, "rank"), (T.SELECT_RANK_MAX_T, "rank"),
                                    (T.SELECT_RANK_MAX_T + 1, "bitonic"),
                                    (T.SELECT_SHARED_SORT_MAX_T, "bitonic"),
                                    (T.SELECT_SHARED_SORT_MAX_T + 1, "global"),
                                    (7812, "global")])
def test_the_route_is_chosen_on_t(t, sort):
    """Every t takes the radix select; t chooses how it sorts the t entries
    it selected. A row with a global sort is never split."""
    plan = T.select_plan(1, 7813, t, SMS)
    assert (plan.route, plan.sort) == ("radix", sort)
    if sort == "global":
        assert (plan.split, plan.slice) == (1, 7813)


@pytest.mark.parametrize("nq,w,t,sms", [(0, 10, 1, SMS), (1, 10, 0, SMS), (1, 10, 11, SMS),
                                        (1, 10, 1, 0)])
def test_the_plan_raises_on_shapes_it_cannot_take(nq, w, t, sms):
    with pytest.raises(ValueError):
        T.select_plan(nq, w, t, sms)


# ---------------------------------------------------------------------------
# (b) routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,w,t,entry", [
    (1, 7813, 24, "ise_select_radix"), (4096, 64, 12, "ise_select_radix"),
    (1, 7813, T.SELECT_RANK_MAX_T + 1, "ise_select_radix"),
    (64, 7813, T.SELECT_SHARED_SORT_MAX_T + 1, "ise_select_radix"),
    (1, 7813, T.SELECT_RANK_MAX_T + 1, "ise_select_topt"),
])
def test_each_route_reaches_its_entry_point(fake_cuda, nq, w, t, entry):  # noqa: F811
    """The radix select for every t; the extract-min kernel only where
    chip_smoke.py asks for it, to time it beside the radix select."""
    lib = fake_cuda()
    T.reset_launch_counts()
    radix = entry == "ise_select_radix"
    with chip_smoke.select_route("radix" if radix else "extract_min"):
        vals, ids = T.select_topt(torch.zeros(nq, w), t)
    assert vals.shape == ids.shape == (nq, t) and ids.dtype == torch.int32
    assert [c[0] for c in lib.calls] == [entry]
    args = lib.calls[0][1]
    plan = T.select_plan(nq, w, t, SMS)
    if radix:
        assert args[7:13] == (nq, w, t, plan.split, plan.slice, int(plan.staged))
        assert all(a != 0 for a in args[3:6]) == (plan.split > 1)  # scratch and counters
        assert (args[6] != 0) == (plan.sort == "global")  # the global sort's scratch
    else:
        assert args[3:6] == (nq, w, t)
    assert (T.select_topt.launches, T.select_topt.radix_launches,
            T.select_topt.extract_min_launches) == (1, int(radix), int(not radix))
    T.reset_launch_counts()
    assert T.select_topt.radix_launches == T.select_topt.extract_min_launches == 0


def test_a_failed_select_launch_raises(fake_cuda):  # noqa: F811
    fake_cuda(rc=1)
    with pytest.raises(RuntimeError, match="select_topt"):
        T.select_topt(torch.zeros(2, 100), 5)


# ---------------------------------------------------------------------------
# (c) the kernel's algorithm in numpy
# ---------------------------------------------------------------------------


def sel_key(v: np.ndarray) -> np.ndarray:
    """csrc/select_topt.cu sel_key: uint32 keys in float order, -0.0 = +0.0,
    NaN after +inf."""
    u = np.asarray(v, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    u[np.isnan(v)] = 0x7FC00000
    return (u ^ np.where(u >> 31, np.uint32(0xFFFFFFFF), np.uint32(0x80000000))).astype(
        np.int64)


def low_ones(hi: int) -> int:
    return 0 if hi < 0 else (1 << (hi + 1)) - 1


def pick_bin(hist: np.ndarray, rem: int):
    incl = np.cumsum(hist)
    b = int(np.argmax(incl >= rem))
    excl = int(incl[b] - hist[b])
    return b, int(hist[b]), rem - excl


def threshold_model(keys: np.ndarray, pos: np.ndarray, t: int):
    """radix_threshold in numpy: the t-th (key, position) pair, and the
    digit passes it took."""
    kmin, kmax, pmin, pmax = (int(keys.min()), int(keys.max()), int(pos.min()),
                              int(pos.max()))
    hi = (kmin ^ kmax).bit_length() - 1
    prefix, cnt, rem, passes = kmin & ~low_ones(hi), keys.size, t, 0
    while cnt != rem and hi >= 0:
        lo = max(hi - 7, 0)
        m = (keys & ~low_ones(hi)) == prefix
        b, cnt, rem = pick_bin(np.bincount((keys[m] >> lo) & low_ones(hi - lo), minlength=256),
                               rem)
        prefix |= b << lo
        hi, passes = lo - 1, passes + 1
    if cnt == rem:
        return (prefix | low_ones(hi), (1 << 32) - 1), passes
    phi = (pmin ^ pmax).bit_length() - 1
    pprefix = pmin & ~low_ones(phi)
    while cnt != rem and phi >= 0:
        lo = max(phi - 7, 0)
        m = (keys == prefix) & ((pos & ~low_ones(phi)) == pprefix)
        b, cnt, rem = pick_bin(np.bincount((pos[m] >> lo) & low_ones(phi - lo), minlength=256),
                               rem)
        pprefix |= b << lo
        phi, passes = lo - 1, passes + 1
    return (prefix, pprefix | low_ones(phi)), passes


def covers(keys, pos, thr):
    return (keys < thr[0]) | ((keys == thr[0]) & (pos <= thr[1]))


RANK_MAX = 512  # SEL_RANK_MAX: candidates ranked without a radix threshold


def rank_model(v, keys, pos, t):
    """rank_select in numpy: each entry's rank is the number of (key,
    position) pairs below it; the entries of rank < t, in rank order."""
    rank = ((keys[None, :] < keys[:, None])
            | ((keys[None, :] == keys[:, None]) & (pos[None, :] < pos[:, None]))).sum(1)
    keep = rank < t
    out_v, out_p = np.empty(t, np.float32), np.empty(t, np.int64)
    out_v[rank[keep]], out_p[rank[keep]] = v[keep], pos[keep]
    return out_v, out_p


def pairs_of(keys, pos) -> np.ndarray:
    return (keys.astype(np.uint64) << np.uint64(32)) | pos.astype(np.uint64)


def bitonic_model(v, keys, pos):
    """sort_selected's bitonic network in numpy: the (key, position) pairs
    padded with the largest pair to a power of two, each stage's
    compare-exchanges at once, the values moved with their pairs."""
    t = v.size
    p = 1 << (t - 1).bit_length()
    kp = np.full(p, np.iinfo(np.uint64).max, np.uint64)
    vv = np.zeros(p, np.float32)
    kp[:t], vv[:t] = pairs_of(keys, pos), v
    i = np.arange(p // 2)
    k = 2
    while k <= p:
        j = k >> 1
        while j > 0:
            lo = 2 * i - (i & (j - 1))
            hi = lo + j
            a, c = kp[lo], kp[hi]
            swap = (a > c) == ((lo & k) == 0)
            kp[lo[swap]], kp[hi[swap]] = c[swap], a[swap]
            vv[lo[swap]], vv[hi[swap]] = vv[hi[swap]], vv[lo[swap]]
            j >>= 1
        k <<= 1
    return vv[:t], (kp[:t] & np.uint64(0xFFFFFFFF)).astype(np.int64)


def global_sort_model(row_v, pos0, keys, pos):
    """global_sort in numpy: the pairs in position order (the compaction's
    scan), then per 8-bit key digit, low first, unless one digit holds them
    all: the histogram's exclusive scan as bases, and each 256 entries in
    order to base + rank among its warp's lanes of that digit + the counts
    of that digit in the warps before it. Values read back from the row by
    position."""
    order = np.argsort(pos, kind="stable")
    src = pairs_of(keys[order], pos[order])
    t = src.size
    for shift in (32, 40, 48, 56):
        dig = ((src >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64)
        hist = np.bincount(dig, minlength=256)
        if hist.max() == t:
            continue
        base = np.cumsum(hist) - hist
        dst = np.empty_like(src)
        for i0 in range(0, t, 256):
            d = dig[i0:i0 + 256]
            warp = np.arange(d.size) // 32
            wd = warp * 256 + d
            by = np.argsort(wd, kind="stable")
            first = np.r_[0, np.flatnonzero(np.diff(wd[by])) + 1]
            rank = np.empty(d.size, np.int64)
            rank[by] = np.arange(d.size) - np.repeat(first, np.diff(np.r_[first, d.size]))
            wcnt = np.zeros((8, 256), np.int64)
            np.add.at(wcnt, (warp, d), 1)
            before = np.cumsum(wcnt, axis=0) - wcnt  # the warps before each
            dst[base[d] + rank + before[warp, d]] = src[i0:i0 + 256]
            base += np.bincount(d, minlength=256)
        src = dst
    out_p = (src & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return row_v[out_p - pos0], out_p


def sort_model(v, keys, pos, t, row=None):
    """sort_selected's sort of the t selected entries (given in any order):
    counting, the bitonic network, or (a whole row's view, ``row`` = its
    values and first position) the global radix sort."""
    if t <= T.SELECT_RANK_MAX_T:
        return rank_model(v, keys, pos, t)
    if t <= T.SELECT_SHARED_SORT_MAX_T:
        return bitonic_model(v, keys, pos)
    return global_sort_model(*row, keys, pos)


def candidates_model(v, keys, pos, t):
    """select_candidates in numpy: (values, positions, digit passes)."""
    if v.size <= RANK_MAX:
        return (*rank_model(v, keys, pos, t), 0)
    thr, passes = threshold_model(keys, pos, t)
    sel = np.random.default_rng(t).permutation(np.nonzero(covers(keys, pos, thr))[0])
    assert sel.size == t  # the slots' order is arbitrary
    return (*sort_model(v[sel], keys[sel], pos[sel], t), passes)


def radix_select_model(v: np.ndarray, pos: np.ndarray, t: int, sample: bool = True):
    """block_select (``sample``: the entries are a row's, positions
    implicit) or, for a merge, select_candidates in numpy: (values,
    positions, digit passes, whether the row's candidates were used)."""
    keys, pos = sel_key(v), pos.astype(np.int64)
    if not sample:
        return (*candidates_model(v, keys, pos, t), False)
    st = T.select_sample_stride(v.size, t)
    if v.size <= RANK_MAX or st > 1:
        cut, passes = ((1 << 32) - 1, (1 << 32) - 1), 0
        if v.size > RANK_MAX:
            cut, passes = threshold_model(keys[::st], pos[::st], t)
        cand = np.nonzero(covers(keys, pos, cut))[0]
        if cand.size <= T._SELECT_CAND_MAX:
            out_v, out_p, n = candidates_model(v[cand], keys[cand], pos[cand], t)
            return out_v, out_p, passes + n, True
    thr, passes = threshold_model(keys, pos, t)
    sel = np.random.default_rng(t).permutation(np.nonzero(covers(keys, pos, thr))[0])
    assert sel.size == t
    return (*sort_model(v[sel], keys[sel], pos[sel], t, row=(v, int(pos[0]))), passes, False)


def select_model(row: np.ndarray, t: int, nq: int = 1):
    """select_radix_kernel over one row on select_plan(nq, W, t)'s split:
    each slice's min(t, n) best, then the merge of the row's candidates by
    their positions. Returns (values, positions, digit passes)."""
    w = row.size
    plan = T.select_plan(nq, w, t, SMS)
    if plan.split == 1:
        return radix_select_model(row, np.arange(w), t)[:3]
    cv, cp, passes = [], [], 0
    for s in range(plan.split):
        lo, hi = s * plan.slice, min(w, (s + 1) * plan.slice)
        v, p, n, _ = radix_select_model(row[lo:hi], np.arange(lo, hi), min(t, hi - lo))
        if t > T.SELECT_RANK_MAX_T:  # emit_unsorted: a slice's candidates in any order
            perm = np.random.default_rng(s).permutation(v.size)
            v, p = v[perm], p[perm]
        cv.append(v)
        cp.append(p)
        passes = max(passes, n)
    v, p, n, _ = radix_select_model(np.concatenate(cv), np.concatenate(cp), t, sample=False)
    return v, p, passes + n


def max_passes(w: int) -> int:
    """Digit passes of one threshold at most: the key's 4 and the position's."""
    return 4 + -(-max(w - 1, 1).bit_length() // 8)


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "inf", "nan"])
@pytest.mark.parametrize("w", [1, 31, 32, 33, 1000, 5088, 7813])
def test_the_radix_select_equals_a_lexsort(kind, w):
    rng = np.random.default_rng(w)
    rows = rows_of(kind, 2, w, rng)
    for t in sorted({1, 12, 24, 160, w - 1, w} & set(range(1, min(w, T.SELECT_RANK_MAX_T) + 1))):
        for nq in (1, 4096):  # a split row and a whole one
            for row in rows:
                v, p, passes = select_model(row, t, nq)
                rv, rp = lexsort_ref(row, t)
                assert same_bits(v, rv) and np.array_equal(p, rp), (kind, w, t, nq)
                # a sample's threshold, the candidates', and a split row's merge
                assert passes <= 3 * max_passes(w), passes


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "inf", "nan"])
@pytest.mark.parametrize("w", [1000, 5088, 7813, 65536])
def test_the_radix_select_beyond_256_equals_a_lexsort(kind, w):
    """t beyond SELECT_RANK_MAX_T: the whole row's threshold (never a
    sample), then the bitonic network (t <= SELECT_SHARED_SORT_MAX_T, also
    in the merges of split rows) or the global radix sort; a split row and a
    whole one."""
    rng = np.random.default_rng(w + 1)
    row = rows_of(kind, 1, w, rng)[0]
    for t in sorted({257, 300, 1000, 4096, w - 1} & set(range(1, w + 1))):
        for nq in ((1, 4096) if t <= T._SELECT_MERGE_MAX // 2 else (1,)):
            v, p, passes = select_model(row, t, nq)
            rv, rp = lexsort_ref(row, t)
            assert same_bits(v, rv) and np.array_equal(p, rp), (kind, w, t, nq)
            assert passes <= 2 * max_passes(w), passes


def test_the_sorts_order_pairs_given_in_any_order():
    """The bitonic network over a non-power-of-two t and the global radix
    sort over keys that share their high digits (skipped passes) and keys
    tied across tiles (position order kept)."""
    rng = np.random.default_rng(11)
    for t in (257, 300, 511, 512, 4096):
        keys = rng.integers(0, 1 << 32, t).astype(np.int64)
        pos = rng.permutation(1 << 16)[:t].astype(np.int64)
        v, p = bitonic_model(rng.standard_normal(t).astype(np.float32), keys, pos)
        want = np.lexsort((pos, keys))
        assert np.array_equal(p, pos[want])
    row = np.repeat(rng.standard_normal(40).astype(np.float32), 250)  # ties of 250 entries
    row[::7] += np.float32(1e-3)
    keys, pos = sel_key(row), np.arange(row.size)
    v, p = global_sort_model(row, 0, keys[::-1].copy(), pos[::-1].copy())
    rv, rp = lexsort_ref(row, row.size)
    assert same_bits(v, rv) and np.array_equal(p, rp)


def test_random_rows_select_from_the_sample_s_candidates():
    row = np.random.default_rng(3).standard_normal(7813).astype(np.float32)
    for t in (12, 24, 52, 160, 256):
        v, p, passes, sampled = radix_select_model(row, np.arange(7813), t)
        assert sampled
        assert passes <= max_passes(7813) + (t > 64) * max_passes(7813)  # ranked up to 512
    tied = np.zeros(65536, np.float32)  # every key tied: the position's two digits only
    assert threshold_model(sel_key(tied), np.arange(65536), 200)[1] == 2


def test_rows_that_hide_their_smallest_from_the_sample_take_the_whole_row():
    """Small entries everywhere but at the sampled positions: the sample's
    threshold lets more than the scratch through, and the select runs over
    the whole row, with the same result."""
    rng = np.random.default_rng(5)
    row = rng.standard_normal(7813).astype(np.float32)
    row[::8] += 100.0
    v, p, _, sampled = radix_select_model(row, np.arange(7813), 24)
    assert not sampled
    rv, rp = lexsort_ref(row, 24)
    assert same_bits(v, rv) and np.array_equal(p, rp)


# ---------------------------------------------------------------------------
# (d) the plain version against the JAX kernel and a lexsort
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t", [1, 15])
def test_the_plain_select_equals_the_jax_kernel(t):
    """Tie-heavy rows and rows with +inf entries, W = 16: values equal; ids
    equal at every finite value. Past a row's last finite entry the JAX
    kernel's passes find only retired (+inf) entries and return id 0 again
    (callers mask +inf slots), where the port's select goes on with the
    +inf entries in position order."""
    rng = np.random.default_rng(16)
    mins = np.concatenate([rows_of("ties", 3, 16, rng), rows_of("inf", 3, 16, rng)])
    pv, pi = T.select_topt_ref(torch.from_numpy(mins), t)
    jv, ji = jax_select_topt(jnp.asarray(mins.T), t, True)
    jv, ji = np.asarray(jv)[:t, :6].T, np.asarray(ji)[:t, :6].T
    np.testing.assert_array_equal(pv.numpy(), jv)
    fin = np.isfinite(jv)
    assert fin[:3].all()
    np.testing.assert_array_equal(pi.numpy()[fin], ji[fin])


@pytest.mark.parametrize("kind", ["random", "ties", "zeros", "inf"])
def test_the_plain_select_equals_a_lexsort(kind):
    mins = rows_of(kind, 6, 333, np.random.default_rng(7))
    for t in (1, 24, 332):
        pv, pi = T.select_topt_ref(torch.from_numpy(mins), t)
        assert pi.dtype == torch.int32
        for r in range(mins.shape[0]):
            rv, rp = lexsort_ref(mins[r], t)
            assert same_bits(pv[r].numpy(), rv) and np.array_equal(pi[r].numpy(), rp)


def test_the_probed_topk_beyond_256_equals_the_jax_kernel():
    """ops/ivf.ivf_probed_topk at k = 300 (the select beyond
    SELECT_RANK_MAX_T) against the JAX package's (its Pallas probed scan in
    interpret mode, its ``select_impl="xla"`` select, ``lax.top_k``, which
    orders ties as its Pallas select does: the Pallas select unrolls its t
    passes, ~12 s of interpret-mode compile at t = 300) on a tiny IVF: 8
    buckets of cap 128, d = 16, 5 probed (W = 640), pad slots with +inf
    norms and id -1, some queries short of k finite entries. ok flags and
    ids equal; distances within 16 f32 ulps of the magnitudes that cancel in
    ||q||^2 - 2 q.x + ||x||^2 (both sum 16 f32 products, in other orders)."""
    rng = np.random.default_rng(300)
    nb, cap, d, nprobe, k = 8, 128, 16, 5, 300
    packed = rng.standard_normal((nb, cap, d)).astype(np.float32)
    fill = rng.integers(30, 90, nb)
    lists = np.full((nb, cap), -1, np.int32)
    norms = np.full((nb, cap), np.inf, np.float32)
    for b in range(nb):
        lists[b, :fill[b]] = b * cap + np.arange(fill[b])
        norms[b, :fill[b]] = (packed[b, :fill[b]].astype(np.float64) ** 2).sum(1)
    bc = packed.mean(1) + rng.standard_normal((nb, d)).astype(np.float32)
    q = rng.standard_normal((4, d)).astype(np.float32)
    pd, pi, pok = IV.ivf_probed_topk(torch.from_numpy(q), torch.from_numpy(bc),
                                     torch.from_numpy(packed), torch.from_numpy(norms),
                                     torch.from_numpy(lists), k, nprobe)
    jd, ji, jok = jax_probed_topk(jnp.asarray(q), jnp.asarray(bc), jnp.asarray(packed),
                                  jnp.asarray(norms), jnp.asarray(lists), k, nprobe,
                                  interpret=True, select_impl="xla")
    pok, jok = pok.numpy(), np.asarray(jok)
    assert tuple(pi.shape) == (4, k) and not pok.all()  # some queries probe fewer than k rows
    np.testing.assert_array_equal(pok, jok)
    np.testing.assert_array_equal(pi.numpy()[pok], np.asarray(ji)[jok])
    xm = float(np.sqrt(norms[np.isfinite(norms)].max()))
    qm = float(np.linalg.norm(q, axis=1).max())
    np.testing.assert_allclose(pd.numpy()[pok], np.asarray(jd)[jok], rtol=1e-5,
                               atol=16 * float(np.finfo(np.float32).eps) * (xm + qm) ** 2)

"""The candidate select (image_search_engine_tpu_torch/ops/topk.py
``select_topt``, ``select_plan``, ``select_topt_ref``; ``csrc/select_topt.cu``).

The radix-select kernel runs only on the card, where ``chip_smoke.py`` holds
it to ``select_topt_ref`` bit for bit over a sweep of shapes and rows. Here:

  (a) the host-side plan as pure functions: the extract-min route beyond
      ``SELECT_RADIX_MAX_T`` and the radix select up to it; a row split
      over blocks only for batches of fewer rows than SMs, into non-empty
      slices that cover the row, each at least t entries, whose candidates
      fit the merge; the staging threshold;
  (b) the routing, with a fake kernel library: each route reaches its
      entry point with the plan's arguments and its own launch counter; a
      failed launch raises;
  (c) the kernel's algorithm, step for step in numpy (the key transform,
      the digit passes from the first bit the entries' keys do not share,
      the stop when a bin holds exactly the entries still wanted, the
      position digits among tied keys, the compaction and the sort by
      counting; first over a sample of every stride-th entry, then over the
      entries at or below the sample's t-th pair, or over the whole row when
      they overflow the scratch; a split row's slices selected unsorted in
      any order and merged by their positions): equal to a numpy lexsort bit
      for bit, -0.0 kept, on random, tie-heavy, +-0.0, +inf and NaN rows,
      with t = 1, W - 1 and W, and a number of digit passes that does not
      grow with t;
  (d) ``select_topt_ref`` against the JAX ``_select_topt`` (interpret mode,
      W = 16) on tie-heavy and +inf rows, t = 1 and t = W - 1 (ids at
      +inf values excepted: there the JAX kernel repeats id 0), and against
      a float64 numpy lexsort, also on rows that mix -0.0 and +0.0 (against
      the lexsort only: XLA's ``min`` may return either zero's sign).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops.topk_pallas import _select_topt as jax_select_topt
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
])
def test_radix_plan_covers_each_row_once(nq, w, t):
    plan = T.select_plan(nq, w, t, SMS)
    assert plan.route == "radix"
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


@pytest.mark.parametrize("t,route", [(1, "radix"), (T.SELECT_RADIX_MAX_T, "radix"),
                                     (T.SELECT_RADIX_MAX_T + 1, "extract_min"),
                                     (7812, "extract_min")])
def test_the_route_is_chosen_on_t(t, route):
    plan = T.select_plan(1, 7813, t, SMS)
    assert plan.route == route
    if route == "extract_min":
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
    (1, 7813, T.SELECT_RADIX_MAX_T + 1, "ise_select_topt"),
])
def test_each_route_reaches_its_entry_point(fake_cuda, nq, w, t, entry):  # noqa: F811
    lib = fake_cuda()
    T.reset_launch_counts()
    vals, ids = T.select_topt(torch.zeros(nq, w), t)
    assert vals.shape == ids.shape == (nq, t) and ids.dtype == torch.int32
    assert [c[0] for c in lib.calls] == [entry]
    args = lib.calls[0][1]
    plan = T.select_plan(nq, w, t, SMS)
    if entry == "ise_select_radix":
        assert args[6:12] == (nq, w, t, plan.split, plan.slice, int(plan.staged))
        assert all(a != 0 for a in args[3:6]) == (plan.split > 1)  # scratch and counters
    else:
        assert args[3:6] == (nq, w, t)
    radix = entry == "ise_select_radix"
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


def candidates_model(v, keys, pos, t):
    """select_candidates in numpy: (values, positions, digit passes)."""
    if v.size <= RANK_MAX:
        return (*rank_model(v, keys, pos, t), 0)
    thr, passes = threshold_model(keys, pos, t)
    sel = np.random.default_rng(t).permutation(np.nonzero(covers(keys, pos, thr))[0])
    assert sel.size == t  # the slots' order is arbitrary
    return (*rank_model(v[sel], keys[sel], pos[sel], t), passes)


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
    return (*rank_model(v[sel], keys[sel], pos[sel], t), passes, False)


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
    for t in sorted({1, 12, 24, 160, w - 1, w} & set(range(1, min(w, T.SELECT_RADIX_MAX_T) + 1))):
        for nq in (1, 4096):  # a split row and a whole one
            for row in rows:
                v, p, passes = select_model(row, t, nq)
                rv, rp = lexsort_ref(row, t)
                assert same_bits(v, rv) and np.array_equal(p, rp), (kind, w, t, nq)
                # a sample's threshold, the candidates', and a split row's merge
                assert passes <= 3 * max_passes(w), passes


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

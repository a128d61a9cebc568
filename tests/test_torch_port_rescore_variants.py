"""The three phase-2 prototype kernels of the port (image_search_engine_tpu_torch/
ops/rescore_variants.py), the approximate select and the five ported scripts
that run them (gather_kernel_proto, gather_kernel_sweep, gather_kernel_sweep2,
rescore_dma_variants, hier_select).

On the CPU each wrapper runs its plain PyTorch version; ``chip_smoke.py``
phase 7 holds the CUDA kernels to these on the card. Here the plain versions
are held against a float64 numpy oracle of the same function, built from the
bf16 values the kernels read, and against the JAX bodies: the fused search of
``benchmarks/gather_kernel_proto.build`` in interpret mode (rows 14 and 15
share its ``rescore_kernel``) and ``rescore_dma_variants._cross_only_kernel``
through an interpret-mode ``pallas_call`` built here as that script builds it
(row 16).

Tolerance: 16 f32 ulps of the magnitudes summed, |norm| + 2 |q| |x|, since the
sums run in another order than float64's and XLA's. Ids must be equal except
between neighbours whose distances lie within that tolerance of each other.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks import gather_kernel_proto as jax_gather_proto
from benchmarks import rescore_dma_variants as jax_dma
from image_search_engine_tpu_torch.benchmarks import common, gather_kernel_proto
from image_search_engine_tpu_torch.benchmarks import gather_kernel_sweep, gather_kernel_sweep2
from image_search_engine_tpu_torch.benchmarks import hier_select, rescore_dma_variants
from image_search_engine_tpu_torch.ops import rescore_variants as RV
from image_search_engine_tpu_torch.ops import topk as T
from image_search_engine_tpu_torch.ops.distances import stable_smallest

EPS32 = float(np.finfo(np.float32).eps)
GROUP = 128
SCRIPTS = [gather_kernel_proto, gather_kernel_sweep, gather_kernel_sweep2, rescore_dma_variants,
           hier_select]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make(seed, n, nq, d=128):
    """bf16 query and store rounded from f32 draws, and the squared norms of
    the bf16 rows (the scripts' norms)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((nq, d)).astype(np.float32)).to(torch.bfloat16)
    return q, x, (x.float() ** 2).sum(1)


def random_cand(seed, nq, n, t):
    """(nq, t) int32 candidate groups, the ragged last group in column 0."""
    ng = -(-n // GROUP)
    cand = np.random.default_rng(seed).integers(0, ng, (nq, t)).astype(np.int32)
    cand[:, 0] = ng - 1
    return torch.from_numpy(cand)


def oracle(q, x, cand):
    """float64 (gather scores, cross products), (Q, t*128), over the bf16
    values: +inf and 0 past N."""
    n = x.shape[0]
    rows = (cand.numpy().astype(np.int64)[:, :, None] * GROUP + np.arange(GROUP)).reshape(
        cand.shape[0], -1)
    valid = rows < n
    xr = x.double().numpy()[np.minimum(rows, n - 1)]
    cross = np.einsum("qrd,qd->qr", xr, q.double().numpy())
    scores = (xr * xr).sum(-1) - 2.0 * cross
    return np.where(valid, scores, np.inf), np.where(valid, cross, 0.0)


def tol(q, x):
    norms = (x.double() ** 2).sum(1)
    return 16 * EPS32 * (float(norms.max()) + 2 * float(q.double().norm(dim=1).max())
                         * float(norms.max()) ** 0.5)


def assert_ids_match(ids, want_ids, want_d, atol):
    """ids equal, except at ranks whose reference distance lies within atol
    of a neighbouring rank's (a near-tie the summation order may flip)."""
    ids, want_ids, want_d = map(np.asarray, (ids, want_ids, want_d))
    step = np.abs(np.diff(want_d.astype(np.float64), axis=1))
    gap = np.full(want_d.shape, np.inf)
    gap[:, 1:] = step
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    bad = (ids != want_ids) & ~(gap <= atol)
    assert not bad.any(), np.argwhere(bad)[:4]


# ---------------------------------------------------------------------------
# The plain versions against float64
# ---------------------------------------------------------------------------

CASES = [(1, 1, 1), (200, 3, 2), (1537, 7, 12), (4000, 5, 1), (4000, 33, 12)]


@pytest.mark.parametrize("n,nq,t", CASES)
@pytest.mark.parametrize("d", (64, 128, 130))
@pytest.mark.parametrize("kind", ("gather", "cross"))
def test_plain_versions_match_float64(n, nq, t, d, kind):
    q, x, _ = make(n + d, n, nq, d)
    cand = random_cand(n + t, nq, n, t)
    want = oracle(q, x, cand)[kind == "cross"]
    ref = (RV.rescore_gather_ref if kind == "gather" else RV.rescore_cross_ref)(q, x, cand)
    assert ref.shape == (nq, t * GROUP) and ref.dtype == torch.float32
    got = ref.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))  # +inf exactly past N
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=tol(q, x))
    if kind == "cross":
        assert (got[oracle(q, x, cand)[0] == np.inf] == 0.0).all()  # 0 exactly past N
    wrapper = RV.rescore_gather if kind == "gather" else RV.rescore_cross
    for qb in RV.QBS:  # on the CPU every wrapper is its plain version, and counts no launch
        assert torch.equal(wrapper(q, x, cand, qb=qb), ref)
    assert RV.launch_counts() == {"rescore_gather": 0, "rescore_cross": 0}


# ---------------------------------------------------------------------------
# Rows 14 and 15 against the JAX search, row 16 against the JAX body
# ---------------------------------------------------------------------------

N_J, D_J, Q_J = 4000, 64, 20  # a ragged last group: 4000 = 31 * 128 + 32


@pytest.fixture(scope="module")
def jax_case():
    rng = np.random.default_rng(14)
    xh = rng.standard_normal((N_J, D_J)).astype(np.float32)
    qh = rng.standard_normal((Q_J, D_J)).astype(np.float32)
    x = torch.from_numpy(xh).to(torch.bfloat16)
    return torch.from_numpy(qh), x, (x.float() ** 2).sum(1)


@pytest.mark.parametrize("qb", (8, 16))
def test_fused_search_matches_jax_gather_kernel_proto(jax_case, qb):
    q, x, xn = jax_case
    jfn = jax_gather_proto.build(N_J, D_J, 512, 2, interpret=True, QB=qb)
    jd, ji = jfn(jnp.asarray(q.numpy()), jnp.asarray(x.float().numpy(), jnp.bfloat16),
                 jnp.asarray(xn.numpy()))
    jd, ji = np.asarray(jd), np.asarray(ji)
    d, i = gather_kernel_proto.build(N_J, D_J, 512, 2, QB=qb)(q, x, xn)
    atol = tol(q.to(torch.bfloat16), x)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=atol)
    assert_ids_match(i.numpy(), ji, jd, atol)


def jax_cross_only(q, x, cand, qb):
    """``_cross_only_kernel`` through an interpret-mode ``pallas_call`` built
    as rescore_dma_variants.py:100-116 builds it: (Q, t*128) f32."""
    nq, d = q.shape
    t = cand.shape[1]
    dp, qp, npad = -(-d // 128) * 128, -(-nq // qb) * qb, -(-x.shape[0] // GROUP) * GROUP
    qf = jnp.pad(jnp.asarray(q.float().numpy(), jnp.bfloat16), ((0, qp - nq), (0, dp - d)))
    xf = jnp.pad(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                 ((0, npad - x.shape[0]), (0, dp - d)))
    cand_flat = jnp.asarray(np.pad(cand.numpy(), ((0, qp - nq), (0, 0))).reshape(-1))

    def xn_map(j):
        return lambda i, jt, c: (c[(i * qb + j) * t + jt], 0)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(qp // qb, t),
        in_specs=[pl.BlockSpec((qb, dp), lambda i, jt, c: (i, 0)),
                  *[pl.BlockSpec((GROUP, dp), xn_map(j)) for j in range(qb)]],
        out_specs=pl.BlockSpec((qb, GROUP), lambda i, jt, c: (i, jt)))
    cross = pl.pallas_call(
        functools.partial(jax_dma._cross_only_kernel, qb=qb), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((qp, t * GROUP), jnp.float32), interpret=True,
    )(cand_flat, qf, *([xf] * qb))
    return np.asarray(cross)[:nq]


def test_cross_matches_jax_cross_only_kernel(jax_case):
    q, x, xn = jax_case
    qf = q.to(torch.bfloat16)
    cand = gather_kernel_proto.candidates(qf, x, xn, 2)  # a real phase 1's groups
    cand[:, -1] = T.num_groups(N_J) - 1  # and the ragged last group
    got = RV.rescore_cross(qf, x, cand).numpy()
    want = jax_cross_only(qf, x, cand, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol(qf, x))
    past = (cand.numpy()[:, :, None] * GROUP + np.arange(GROUP)).reshape(Q_J, -1) >= N_J
    assert past.any() and (got[past] == 0.0).all() and (want[past] == 0.0).all()


def test_cross_only_search_returns_pad_rows_when_n_below_k():
    """N = 5 < k = 10: the JAX script's epilogue (rescore_dma_variants.py:
    118-128) ranks the five rows, then pad rows 5-9 of group 0 at 1e30."""
    q, x, xn = make(5, 5, 3, 64)
    qf32 = q.float()
    d, i = rescore_dma_variants.twophase_cross_only(qf32, x, 10, x_norms=xn, t_margin=2, qb=8)
    cand = torch.zeros((3, 1), dtype=torch.int32)
    cross = jnp.asarray(jax_cross_only(q, x, cand, 8))
    norms = jnp.pad(jnp.asarray(xn.numpy()), (0, GROUP - 5), constant_values=1e30)
    cn = norms.reshape(1, GROUP)[jnp.asarray(cand.numpy())].reshape(3, GROUP)
    vals, pos = jax.lax.top_k(-(cn - 2.0 * cross), 10)
    flat_ids = (jnp.asarray(cand.numpy())[..., None] * GROUP + jnp.arange(GROUP)).reshape(3, GROUP)
    jid = np.asarray(jnp.take_along_axis(flat_ids, pos, axis=1))
    qnorm = jnp.sum(jnp.asarray(qf32.numpy()) ** 2, axis=1, keepdims=True)
    jd = np.asarray(jnp.maximum(-vals + qnorm, 0.0))
    assert np.array_equal(i.numpy(), jid) and (i.numpy()[:, 5:] == np.arange(5, 10)).all()
    assert (d.numpy()[:, 5:] == np.float32(1e30)).all() and (jd[:, 5:] == np.float32(1e30)).all()
    np.testing.assert_allclose(d.numpy()[:, :5], jd[:, :5], rtol=0, atol=tol(q, x))


# ---------------------------------------------------------------------------
# The approximate select (gather_kernel_sweep2)
# ---------------------------------------------------------------------------

S2 = gather_kernel_sweep2


@pytest.mark.parametrize("n", (100, 128, 200, 300))
def test_approx_select_is_exact_without_reduction(n):
    mins = torch.from_numpy(np.random.default_rng(n).integers(0, 50, (9, n)).astype(np.float32))
    assert S2.approx_reduction(n, 12, 0.95) == 0
    got, want = S2.approx_smallest(mins, 12), stable_smallest(mins, 12)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_approx_reduction_follows_xla_rule():
    # 7,813 groups (1M rows), t = 12, 0.95: (1 - 12) / ln 0.95 = 214.4 bins at
    # least; 7813 // 214 = 36, so 2^5 groups a bin, 245 bins
    assert S2.approx_reduction(7813, 12, 0.95) == 5
    assert S2.approx_reduction(500, 12, 0.95) == 1  # 500 // 214 = 2
    assert S2.approx_reduction(1_000_000, 10, 0.9) == 12  # 128 bins at least; capped at 13
    assert S2.approx_reduction(1000, 12, 0.999) == 0  # ~10,994 bins wanted, capped at n
    with pytest.raises(ValueError, match="recall_target"):
        S2.approx_reduction(1000, 12, 1.0)


def test_approx_select_recall_at_the_bench_point():
    """ngroups = 7,813, t = 12, Q = 64, recall target 0.95: the values are the
    selected groups' own, ascending, and recall against exact >= 0.92."""
    mins = torch.from_numpy(np.random.default_rng(7813).standard_normal((64, 7813))
                            .astype(np.float32))
    vals, pos = S2.approx_smallest(mins, 12)
    assert pos.shape == (64, 12) and torch.equal(vals, torch.gather(mins, 1, pos))
    assert (vals[:, 1:] >= vals[:, :-1]).all()
    assert all(len(set(r)) == 12 for r in pos.tolist())
    _, exact = stable_smallest(mins, 12)
    hit = (pos[:, :, None] == exact[:, None, :]).any(2).double().mean().item()
    assert hit >= 0.92
    # entries i and i + 245 j share a bin, so no two picks share one
    assert all(len({p % 245 for p in r}) == 12 for r in pos.tolist())


# ---------------------------------------------------------------------------
# The ported scripts, on the CPU at tiny sizes
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--n", "3001", "--q", "16", "--iters", "2"]
HEADS = {
    gather_kernel_proto: ["agreement with shipped phase-2 = ", "recall@10 vs float64: shipped=",
                          "validation fused m2 vs fused m6: ", "validation fused m3 vs fused m6: ",
                          "fused phase-2: "],
    gather_kernel_sweep: ["phase1-only m2: ", "fused m2 QB=16: ", "fused m2 QB=32: ",
                          "fused m3 QB=16: "],
    gather_kernel_sweep2: ["sweep-only: ", "sweep+select(exact): ", "sweep+select(approx .95): ",
                           "fused m3 approx.95: ", "fused m2 exact (ref): ",
                           "fused m2 Q=32 tile=2048: "],
    rescore_dma_variants: ["variant vs production id-set mismatches: 0 / 16", "production: ",
                           "cross-only: "],
    hier_select: ["hier(m'=4,m=2) vs production m2: 0 / 32 mismatches", "production m2: ",
                  "hier m'=4 m=2: "],
}


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__.rsplit(".", 1)[1])
def test_ported_script_runs_on_cpu(script, capsys):
    assert script.main(TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(HEADS[script])
    for line, head in zip(lines, HEADS[script]):
        assert line.startswith(head), (line, head)
        for part in line.split("recall@10=")[1:]:
            assert float(part.split(",")[0]) >= 0.9, line


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__.rsplit(".", 1)[1])
def test_exact_script_searches_equal_the_production_search(script):
    """Every exact search of the script returns the production two-phase
    search's ids (bf16 store, the bf16 rows' norms); distances ascend."""
    store = common.make_store(5000, 128, seed=0, device="cpu")
    x, xn = store.x, store.norms_bf16_rows()
    q = common.queries(store, 1, 12)[0]
    _, want = T.topk_twophase(q, x, 10, "l2", x_norms=xn)
    runs = [(name, fn) for name, fn in script.searches(x, xn) if "approx" not in name]
    assert runs
    for name, fn in runs:
        d, i = fn(q)
        assert torch.equal(i, want), name
        assert (d[:, 1:] >= d[:, :-1]).all(), name


def test_phase1_variants_equal_the_production_kernels():
    """The phase-1-only search's groups are the production select's, and the
    sweep alone sums the production group mins."""
    store = common.make_store(5000, 128, seed=0, device="cpu")
    x, xn = store.x, store.norms_bf16_rows()
    q = common.queries(store, 1, 12)[0]
    mins = T.groupmin(q.to(torch.bfloat16), x, xn)
    _, fn = gather_kernel_sweep.phase1(x, xn)
    assert torch.equal(fn(q)[1], T.select_topt(mins, 12)[1])
    parts = dict(gather_kernel_sweep2.partials(x, xn))
    assert torch.equal(parts["sweep-only"](q)[0], mins.sum()[None, None])
    assert torch.equal(parts["sweep+select(exact)"](q)[1], T.select_topt(mins, 12)[1])


@pytest.mark.parametrize("fn", (RV.rescore_gather, RV.rescore_cross), ids=lambda f: f.__name__)
def test_wrappers_reject_what_the_kernels_do_not_take(fn):
    q, x, _ = make(0, 300, 2)  # 3 groups
    cand = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="bf16"):
        fn(q, x.float(), cand)
    with pytest.raises(ValueError, match="bf16"):
        fn(q.float(), x, cand)
    for bad in (cand.long(), cand[:1], cand[:, :, None]):
        with pytest.raises(ValueError, match="cand"):
            fn(q, x, bad)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q, x.T.contiguous().T, cand)
    with pytest.raises(ValueError, match="contiguous"):
        fn(q, x, cand.T.contiguous().T)
    with pytest.raises(ValueError, match="ngroups"):
        fn(q, x, torch.zeros((2, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="qb"):
        fn(q, x, cand, qb=4)


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda s: s.__name__.rsplit(".", 1)[1])
def test_script_never_picks_the_cpu(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main(["--n", "100", "--q", "2", "--iters", "1"])

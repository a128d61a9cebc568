"""The last five ported ``pallas_call`` sites and the margin scripts beside
them (image_search_engine_tpu_torch/benchmarks/: ``twophase_breakdown``,
``rescore_variants``, ``rescore_variants3``, ``margin_validation``,
``certificate_cost``), and ``groupmin_variants.groupmin_tiled``.

On the CPU each wrapper runs its plain PyTorch version; ``chip_smoke.py``
phase 6 holds the CUDA kernels to these on the card. Here each script's
search is held against the JAX script's own function on the same seeded
inputs: production's ``_groupmin_kernel`` / ``_groupmin_kernel_q8``
through an interpret-mode ``pallas_call`` built here at N = 512, tile 256,
then the script's few lines of jnp rescore, copied below. k = 2 there, so
that the select keeps 2 or 3 of the 4 groups.

Tolerances: ids equal; distances within 16 f32 ulps of the magnitudes
summed, |norm| + 2 |q| |x| (the bf16 and f32 rescores sum in another
order than XLA's; the int8 cross term is exact in both, and only the
query's norm is summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from image_search_engine_tpu.ops.topk_pallas import _groupmin_kernel as jax_groupmin_kernel
from image_search_engine_tpu.ops.topk_pallas import _groupmin_kernel_q8 as jax_groupmin_kernel_q8
from image_search_engine_tpu.ops.topk_pallas import quantize_store_int8
from image_search_engine_tpu_torch.benchmarks import certificate_cost, common, margin_validation
from image_search_engine_tpu_torch.benchmarks import rescore_variants, rescore_variants3
from image_search_engine_tpu_torch.benchmarks import twophase_breakdown
from image_search_engine_tpu_torch.ops import groupmin_variants as GV
from image_search_engine_tpu_torch.ops import topk as T

EPS32 = float(np.finfo(np.float32).eps)
SCRIPTS = [twophase_breakdown, rescore_variants, rescore_variants3, margin_validation,
           certificate_cost]


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def tol(q, x, norms):
    return 16 * EPS32 * (float(norms.max()) + 2 * float(q.float().norm(dim=1).max())
                         * float(x.float().norm(dim=1).max()))


# ---------------------------------------------------------------------------
# groupmin_tiled: production's sweep on a chosen query tile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bq", T.MMA_BQ)
def test_groupmin_tiled_plain_equals_groupmin(bq):
    store = common.make_store(1000, 128, seed=bq, device="cpu")
    q = common.queries(store, 1, 37)[0].to(torch.bfloat16)
    norms = store.norms_bf16_rows()
    got = GV.groupmin_tiled(q, store.x, norms, bq)
    assert got.shape == (37, T.num_groups(1000)) and got.dtype == torch.float32
    assert torch.equal(got, T.groupmin(q, store.x, norms))


@pytest.mark.parametrize("bq", T.MMA_BQ)
def test_mma_plan_takes_the_query_tile(bq):
    """At the bench point every tile gives a plan the kernel takes; the
    production plan (no tile given) is unchanged."""
    p = T.mma_plan(2048, 1_000_000, 128, bq=bq)
    assert p.bq == bq and p.nqt == 2048 // bq
    assert p.grid == -(-p.ngroups // p.gps) * p.nqt
    assert p.smem <= T._MMA_SMEM_TWO_BLOCKS and p.dp == 128
    assert T.mma_plan(2048, 1_000_000, 128) == T.mma_plan(2048, 1_000_000, 128, bq=128)
    assert T.mma_plan(20, 1_000_000, 128).bq == 32


def test_groupmin_tiled_rejects_what_the_kernel_does_not_take():
    store = common.make_store(300, 128, seed=0, device="cpu")
    q = common.queries(store, 1, 4)[0].to(torch.bfloat16)
    norms = store.norms_bf16_rows()
    for bq in (8, 256, 512):
        with pytest.raises(ValueError, match="query tile"):
            GV.groupmin_tiled(q, store.x, norms, bq)
        with pytest.raises(ValueError, match="query tile"):
            T.mma_plan(2048, 1000, 128, bq=bq)
    with pytest.raises(ValueError, match="bf16"):
        GV.groupmin_tiled(q.float(), store.x, norms, 16)


def test_breakdown_parity_verdicts():
    a = torch.tensor([[1.0, 2.0]])
    assert twophase_breakdown.parity(a.clone(), a) == "bit-equal"
    assert twophase_breakdown.parity(a + 1e-6, a).startswith("OK")
    assert twophase_breakdown.parity(a + 1e-3, a) == "MISMATCH"


# ---------------------------------------------------------------------------
# The scripts' searches against the JAX scripts' functions (N = 512)
# ---------------------------------------------------------------------------

N_J, TILE_J, Q_J, K_J = 512, 256, 16, 2


def pallas_mins(body, ins, in_specs):
    """(ngroups, Q_J) group mins of production's body over N_J rows, grid
    over TILE_J-row tiles, Pallas in interpret mode."""
    return pl.pallas_call(
        lambda *refs: body(*refs, tile_n=TILE_J), grid=(N_J // TILE_J,), in_specs=in_specs,
        out_specs=pl.BlockSpec((TILE_J // 128, Q_J), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((N_J // 128, Q_J), jnp.float32), interpret=True,
    )(*ins)


def jax_rescore(mins, q, qf, xf, norms, t, mode, sq=None, scale_pad=None):
    """The scripts' jnp lines after their pallas_call (rescore_variants.py
    :94-109, rescore_variants3.py :92-103 and :136-151), with qn_rows = Q_J,
    d = dp = 128 and npad = N_J."""
    qn_rows, dp, ngroups, GROUP = Q_J, 128, N_J // 128, 128
    _, cand_groups = jax.lax.top_k(-mins.T[:qn_rows], t)
    offsets = jnp.arange(GROUP, dtype=jnp.int32)
    flat_ids = (cand_groups[..., None] * GROUP + offsets).reshape(qn_rows, t * GROUP)
    vecs = xf.reshape(ngroups, GROUP, dp)[cand_groups].reshape(qn_rows, t * GROUP, dp)
    cn = norms.reshape(ngroups, GROUP)[cand_groups].reshape(qn_rows, t * GROUP)
    if mode == "bf16":
        cross = jnp.einsum("qd,qcd->qc", qf[:qn_rows], vecs, preferred_element_type=jnp.float32)
    elif mode == "f32":
        cross = jnp.einsum("qd,qcd->qc", q.astype(jnp.float32), vecs,
                           preferred_element_type=jnp.float32,
                           precision=jax.lax.Precision.HIGHEST)
    else:
        csc = scale_pad.reshape(ngroups, GROUP)[cand_groups].reshape(qn_rows, t * GROUP)
        cross_i = jnp.einsum("qd,qcd->qc", qf[:qn_rows], vecs, preferred_element_type=jnp.int32)
        cross = cross_i.astype(jnp.float32) * (sq[:, None] * csc)
    dist = cn - 2.0 * cross
    vals, pos = jax.lax.top_k(-dist, K_J)
    ids = jnp.take_along_axis(flat_ids, pos, axis=1)
    qnorm = jnp.sum(q.astype(jnp.float32) * q, axis=1, keepdims=True)
    return np.asarray(jnp.maximum(-vals + qnorm, 0.0)), np.asarray(ids)


@pytest.fixture(scope="module")
def case():
    """The scripts' data at N = 512: f32 rows, their bf16 store with the f32
    rows' norms, the int8 store with its dequantized rows' norms, f32
    queries; then production's bf16 and int8 bodies' group mins."""
    store = common.make_store(N_J, 128, seed=3, device="cpu")
    q = common.queries(store, 1, Q_J)[0]
    codes, scales, xn8 = rescore_variants3.int8_store(store)
    nf32 = store.norms_f32_rows()
    qj, xj = jnp.asarray(q.numpy()), jnp.asarray(store.x.float().numpy(), jnp.bfloat16)
    qf = qj.astype(jnp.bfloat16)
    row = pl.BlockSpec((TILE_J,), lambda i: (i,))
    tile = pl.BlockSpec((TILE_J, 128), lambda i: (i, 0))
    mins_bf16 = pallas_mins(jax_groupmin_kernel, (qf, jnp.asarray(nf32.numpy()), xj),
                            [pl.BlockSpec((Q_J, 128), lambda i: (0, 0)), row, tile])
    # rescore_variants3.py:113-114, the query quantized per row
    sq = jnp.maximum(jnp.max(jnp.abs(qj), axis=1), 1e-12) / 127.0
    q_int = jnp.clip(jnp.round(qj / sq[:, None]), -127, 127).astype(jnp.int8)
    cj, sj = quantize_store_int8(jnp.asarray(store.x32.numpy()))
    mins_q8 = pallas_mins(jax_groupmin_kernel_q8,
                          (q_int, sq, jnp.asarray(xn8.numpy()), sj, cj),
                          [pl.BlockSpec((Q_J, 128), lambda i: (0, 0)),
                           pl.BlockSpec((Q_J,), lambda i: (0,)), row, row, tile])
    return dict(store=store, q=q, qj=qj, qf=qf, xj=xj, nf32=nf32, codes=codes, scales=scales,
                xn8=xn8, cj=cj, sj=sj, sq=sq, q_int=q_int, mins_bf16=mins_bf16, mins_q8=mins_q8)


def test_int8_store_and_query_are_the_jax_scripts(case):
    c = case
    assert np.array_equal(c["codes"].numpy(), np.asarray(c["cj"]))
    assert np.array_equal(c["scales"].numpy(), np.asarray(c["sj"]))
    qi, sq = T.quantize_int8(c["q"])
    assert np.array_equal(qi.numpy(), np.asarray(c["q_int"]))
    assert np.array_equal(sq.numpy(), np.asarray(c["sq"]))


@pytest.mark.parametrize("margin", [0, 1])
@pytest.mark.parametrize("bf16_rescore", [True, False])
def test_twophase_var_matches_the_jax_script(case, margin, bf16_rescore):
    """rescore_variants.twophase_var (v1, v2 and the f32 rescore) and
    rescore_variants3.twophase_bf16 against their JAX functions."""
    c = case
    x, xn = c["store"].x, c["nf32"]
    d, i = rescore_variants.twophase_var(c["q"], x, xn, t_margin=margin,
                                         bf16_rescore=bf16_rescore, k=K_J)
    jd, ji = jax_rescore(c["mins_bf16"], c["qj"], c["qf"], c["xj"], jnp.asarray(xn.numpy()),
                         K_J + margin, "bf16" if bf16_rescore else "f32")
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=tol(c["q"], x, xn))
    if bf16_rescore:
        d3, i3 = rescore_variants3.twophase_bf16(c["q"], x, xn, t_margin=margin, k=K_J)
        assert torch.equal(i3, i) and torch.equal(d3, d)


@pytest.mark.parametrize("margin", [0, 1])
def test_twophase_int8_matches_the_jax_script(case, margin):
    c = case
    d, i = rescore_variants3.twophase_int8(c["q"], c["codes"], c["scales"], c["xn8"],
                                           t_margin=margin, k=K_J)
    jd, ji = jax_rescore(c["mins_q8"], c["qj"], c["q_int"], c["cj"], jnp.asarray(c["xn8"].numpy()),
                         K_J + margin, "int8", sq=c["sq"], scale_pad=c["sj"])
    np.testing.assert_array_equal(i.numpy(), ji)
    deq = c["codes"].float() * c["scales"][:, None]
    np.testing.assert_allclose(d.numpy(), jd, rtol=0, atol=tol(c["q"], deq, c["xn8"]))


@pytest.mark.parametrize("margin", [1, 2])
def test_twophase_int8_equals_topk_twophase(margin):
    """The script's epilogue is production's bit for bit: the ids and the
    distances of topk_twophase over the same int8 store."""
    store = common.make_store(5000, 128, seed=11, device="cpu")
    codes, scales, xn8 = rescore_variants3.int8_store(store)
    q = common.queries(store, 1, 12)[0]
    d, i = rescore_variants3.twophase_int8(q, codes, scales, xn8, t_margin=margin)
    wd, wi = T.topk_twophase(q, codes, 10, "l2", x_norms=xn8, x_scale=scales, t_margin=margin)
    assert torch.equal(i, wi) and torch.equal(d, wd)


def test_twophase_int8_refuses_rows_its_f32_sums_cannot_hold():
    codes = torch.zeros((4, rescore_variants3.INT8_EXACT_D + 1), dtype=torch.int8)
    with pytest.raises(ValueError, match="2\\^24"):
        rescore_variants3.twophase_int8(torch.ones((1, codes.shape[1])), codes,
                                        torch.ones(4), torch.ones(4), t_margin=0)


# ---------------------------------------------------------------------------
# Margin and certificate counts
# ---------------------------------------------------------------------------


def planted():
    """Five queries, k = 3, against a wider margin's answer: 0 the same; 1
    the same set in another order; 2 a true mismatch (another k-th row,
    farther); 3 a boundary tie (another k-th row at the same distance, to
    1e-7 relative); 4 a true mismatch that the certificate passes."""
    d_ref = torch.tensor([[1.0, 2.0, 3.0]] * 5)
    i_ref = torch.tensor([[1, 2, 3]] * 5)
    d_m = d_ref.clone()
    i_m = i_ref.clone()
    i_m[1] = torch.tensor([2, 1, 3])
    i_m[2, 2], d_m[2, 2] = 9, 3.5
    i_m[3, 2], d_m[3, 2] = 9, 3.0000003
    i_m[4, 2], d_m[4, 2] = 8, 4.0
    cert = torch.tensor([True, True, False, True, True])
    return d_ref, i_ref, d_m, i_m, cert


def test_margin_split_tells_mismatches_from_ties():
    d_ref, i_ref, d_m, i_m, _ = planted()
    miss, tie = common.margin_split(d_ref, i_ref, d_m, i_m)
    assert miss.tolist() == [False, False, True, False, True]
    assert tie.tolist() == [False, False, False, True, False]


def test_margin_counts_sum_trips_and_certified_mismatches_over_dispatches():
    d_ref, i_ref, d_m, i_m, cert = planted()
    qs = torch.zeros((3, 5, 1))
    with_cert = common.margin_counts(lambda q: (d_m, i_m, cert), lambda q: (d_ref, i_ref), qs)
    assert with_cert == {"queries": 15, "mismatches": 6, "ties": 3, "trips": 3,
                         "certified_mismatches": 3}
    without = common.margin_counts(lambda q: (d_m, i_m), lambda q: (d_ref, i_ref), qs)
    assert without == {"queries": 15, "mismatches": 6, "ties": 3}


def test_margin_and_certificate_scripts_count_a_real_search():
    """Production's search is exact at every margin on the CPU's plain
    versions (each group min is the min of its rescored rows), so no query
    is a true mismatch and none is certified wrongly; the helpers' counts
    cover every dispatched query."""
    store = common.make_store(3000, 128, seed=5, device="cpu")
    qs = common.queries(store, 2, 8)
    st = margin_validation.stores(store)
    got = margin_validation.validate(st, qs, {"bf16": (0, 1), "int8": (1,)})
    assert sorted(got) == [("bf16", 0), ("bf16", 1), ("int8", 1)]
    for c in got.values():
        assert c["queries"] == 16 and c["mismatches"] == 0 and c["certified_mismatches"] == 0
    trips = certificate_cost.trips(store.x, store.norms_bf16_rows(), qs)
    assert sorted(trips) == [0, 1, 2]
    assert all(c["certified_mismatches"] == 0 and c["mismatches"] == 0 for c in trips.values())
    assert 0.9 <= margin_validation.int8_recall(st, qs[0], store.x32) <= 1.0


# ---------------------------------------------------------------------------
# The scripts on the CPU, only when asked
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--n", "3001", "--q", "16", "--iters", "2"]


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_script_runs_on_cpu(script, capsys):
    argv = TINY + (["--qblks", "16", "128"] if script is twophase_breakdown else [])
    assert script.main(argv) == 0
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    if script is twophase_breakdown:
        assert out.count("parity vs production: bit-equal") == 2 and "certified: 100.0%" in out
    elif script is rescore_variants:
        assert [ln.split(":")[0] for ln in lines] == [
            "v0 current", "v1 bf16-rescore t=k+4", "v2 bf16-rescore t=k+2"]
        assert all("recall@10=1.00000" in ln for ln in lines)
    elif script is rescore_variants3:
        assert "ids = topk_twophase's over the int8 store: True" in out
        assert out.count("validation t=k+") == 2 and "over 32 queries" in out
    elif script is margin_validation:
        assert out.count("validation ") == 4 and "certified mismatches 0" in out
        assert "int8 margin=2 recall@10 vs f32 brute force over 16 queries" in out
    else:
        assert out.count("certificate trips") == 3 and "certificate cost" in out


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_script_never_picks_the_cpu(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        script.main(["--n", "100", "--q", "2", "--iters", "1"])

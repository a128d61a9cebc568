"""The four phase-1 prototype kernels of the port (image_search_engine_tpu_torch/
ops/groupmin_variants.py), the ported benchmark scripts and the bench twin.

On the CPU each wrapper runs its plain PyTorch version; ``chip_smoke.py``
phase 6 holds the CUDA kernels to these on the card. Here the plain versions
are held against a float64 numpy oracle of the same function, built from
the bf16-rounded inputs the scripts score, and against the JAX bodies:
``subgroup_proto._kernel_two_level`` and ``subgroup_variants._kernel`` (rows
12 and 13, module-level functions) and the production ``_groupmin_kernel``
(what rows 10 at G = 128 and 11 compute; their own bodies are closures in
the scripts' ``main``), each through an interpret-mode ``pallas_call`` built
here at N = 512, tile 256.

Tolerances: f32 mins within 16 f32 ulps of the magnitudes summed, |norm| +
2 |q| |x| (the sums run in another order than float64's); bf16 subgroup
mins within one bf16 ulp of the oracle's rounding (an f32 min a few ulps
off can round to the neighbouring bf16).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from benchmarks import subgroup_proto as jax_subgroup_proto
from benchmarks import subgroup_variants as jax_subgroup_variants
from image_search_engine_tpu.ops.topk_pallas import _groupmin_kernel as jax_groupmin_kernel
from image_search_engine_tpu_torch import bench
from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.benchmarks import rescore_variants2, subgroup_proto
from image_search_engine_tpu_torch.benchmarks import subgroup_variants, sweep_chunked
from image_search_engine_tpu_torch.ops import groupmin_variants as GV
from image_search_engine_tpu_torch.ops import topk as T

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def make(seed, n, nq, d=128):
    """bf16 query and store as the scripts make them (f32 draws rounded),
    and both norms: of the f32 rows (rows 10, 12, 13) and of the bf16 rows
    (row 11)."""
    rng = np.random.default_rng(seed)
    x32 = rng.standard_normal((n, d)).astype(np.float32)
    q32 = rng.standard_normal((nq, d)).astype(np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    q = torch.from_numpy(q32).to(torch.bfloat16)
    nf32 = torch.from_numpy((x32 * x32).sum(1))
    nbf = (x.float() ** 2).sum(1)
    return q, x, nf32, nbf


def oracle_mins(q, x, norms, width):
    """(Q, ceil(N/width)) float64 mins of norms - 2 q.x over the bf16 values."""
    qd, xd = q.double().numpy(), x.double().numpy()
    s = norms.double().numpy()[None, :] - 2.0 * qd @ xd.T
    pad = -s.shape[1] % width
    s = np.pad(s, ((0, 0), (0, pad)), constant_values=np.inf)
    return s.reshape(s.shape[0], -1, width).min(2)


def tol(q, x, norms):
    return 16 * EPS32 * (float(norms.max()) + 2 * float(q.float().norm(dim=1).max())
                         * float(x.float().norm(dim=1).max()))


def bf16_ulps(a, ref):
    """|a - ref| in units of ref's bf16 spacing; inf must match inf."""
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isinf(a), np.isinf(ref))
    fin = np.isfinite(ref)
    _, e = np.frexp(ref[fin])
    return float((np.abs(a[fin] - ref[fin]) / np.ldexp(1.0, e - 8)).max()) if fin.any() else 0.0


def bf16_round(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).double().numpy()


SHAPES = [(1, 1), (31, 3), (33, 7), (129, 2), (1000, 5), (4097, 9)]


@pytest.mark.parametrize("n,nq", SHAPES)
@pytest.mark.parametrize("group", GV.WIDTHS)
def test_groupmin_width_plain_matches_float64(n, nq, group):
    q, x, nf32, _ = make(n + group, n, nq)
    got = GV.groupmin_width(q, x, nf32, group).numpy()
    want = oracle_mins(q, x, nf32, group).T
    assert got.shape == (-(-n // group), nq) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol(q, x, nf32))
    if group == 128:  # the production kernel's function, group-major
        assert torch.equal(torch.from_numpy(got), T.groupmin(q, x, nf32).T)


@pytest.mark.parametrize("n,nq", SHAPES)
@pytest.mark.parametrize("layout", GV.LAYOUTS)
def test_groupmin_two_level_plain_matches_float64(n, nq, layout):
    q, x, nf32, _ = make(n + 7, n, nq)
    gmin, smin = GV.groupmin_two_level(q, x, nf32, layout)
    assert gmin.shape == (-(-n // 128), nq) and gmin.dtype == torch.float32
    assert smin.shape == (nq, -(-n // 32)) and smin.dtype == torch.bfloat16
    sub = oracle_mins(q, x, nf32, 32)
    np.testing.assert_allclose(gmin.numpy(), oracle_mins(q, x, nf32, 128).T, rtol=0,
                               atol=tol(q, x, nf32))
    assert bf16_ulps(smin.float().numpy(), bf16_round(sub)) <= 1.0
    # a group's min is the min of its subgroups', and rounds to their bf16 min
    pad = -smin.shape[1] % 4
    s4 = torch.nn.functional.pad(smin.float(), (0, pad), value=float("inf"))
    assert torch.equal(gmin.T.to(torch.bfloat16).float(), s4.view(nq, -1, 4).amin(2))
    assert torch.equal(gmin, T.groupmin(q, x, nf32).T)


@pytest.mark.parametrize("n,nq", SHAPES)
@pytest.mark.parametrize("chunk", GV.CHUNKS)
def test_groupmin_chunked_plain_matches_float64(n, nq, chunk):
    q, x, _, nbf = make(n + chunk, n, nq)
    got = GV.groupmin_chunked(q, x, nbf, chunk).numpy()
    np.testing.assert_allclose(got, oracle_mins(q, x, nbf, 128).T, rtol=0, atol=tol(q, x, nbf))


def test_wrappers_reject_what_the_kernels_do_not_take():
    q, x, nf32, _ = make(0, 300, 2)
    with pytest.raises(ValueError, match="bf16"):
        GV.groupmin_width(q.float(), x, nf32, 128)
    with pytest.raises(ValueError, match="group"):
        GV.groupmin_width(q, x, nf32, 16)
    with pytest.raises(ValueError, match="layout"):
        GV.groupmin_two_level(q, x, nf32, "v4")
    with pytest.raises(ValueError, match="chunk"):
        GV.groupmin_chunked(q, x, nf32, 256)
    with pytest.raises(ValueError, match="norms"):
        GV.groupmin_chunked(q, x, nf32[:-1], 512)


# ---------------------------------------------------------------------------
# The JAX bodies, in interpret mode, at one tiny shape (three calls)
# ---------------------------------------------------------------------------

N_J, TILE_J, Q_J = 512, 256, 16


def interpret(body, q, x, xn, out_specs, out_shape):
    """body over the (Q_J, 128) bf16 query, (N_J,) norms and (N_J, 128) bf16
    store, grid over TILE_J-row tiles, Pallas in interpret mode."""
    return pl.pallas_call(
        body, grid=(N_J // TILE_J,),
        in_specs=[pl.BlockSpec((Q_J, 128), lambda i: (0, 0)),
                  pl.BlockSpec((TILE_J,), lambda i: (i,)),
                  pl.BlockSpec((TILE_J, 128), lambda i: (i, 0))],
        out_specs=out_specs, out_shape=out_shape, interpret=True,
    )(jnp.asarray(q.float().numpy(), jnp.bfloat16), jnp.asarray(xn.numpy()),
      jnp.asarray(x.float().numpy(), jnp.bfloat16))


@pytest.fixture(scope="module")
def jax_case():
    return make(512, N_J, Q_J)


def two_level_specs(sub_major):
    g = pl.BlockSpec((TILE_J // 128, Q_J), lambda i: (i, 0))
    f32 = jax.ShapeDtypeStruct((N_J // 128, Q_J), jnp.float32)
    if sub_major:
        return ((g, pl.BlockSpec((TILE_J // 32, Q_J), lambda i: (i, 0))),
                (f32, jax.ShapeDtypeStruct((N_J // 32, Q_J), jnp.bfloat16)))
    return ((g, pl.BlockSpec((Q_J, TILE_J // 32), lambda i: (0, i))),
            (f32, jax.ShapeDtypeStruct((Q_J, N_J // 32), jnp.bfloat16)))


@pytest.mark.parametrize("body", ["subgroup_proto", "subgroup_variants_v3"])
def test_two_level_matches_jax_body(jax_case, body):
    """Row 12 (query-major subgroup mins) and row 13's v3 (subgroup-major,
    transposed after) against the port's v1 and v3."""
    q, x, nf32, _ = jax_case
    sub_major = body.endswith("v3")
    if sub_major:
        kernel = functools.partial(jax_subgroup_variants._kernel, tile_n=TILE_J, variant="v3")
    else:
        kernel = functools.partial(jax_subgroup_proto._kernel_two_level, tile_n=TILE_J)
    jg, js = interpret(kernel, q, x, nf32, *two_level_specs(sub_major))
    jg, js = np.asarray(jg), np.asarray(js.astype(jnp.float32))
    if sub_major:
        js = js.T
    gmin, smin = GV.groupmin_two_level(q, x, nf32, "v3" if sub_major else "v1")
    np.testing.assert_allclose(gmin.numpy(), jg, rtol=0, atol=tol(q, x, nf32))
    assert bf16_ulps(smin.float().numpy(), js) <= 1.0


def test_width_and_chunked_match_jax_groupmin_kernel(jax_case):
    """Rows 10 (G = 128) and 11 compute the production body's function."""
    q, x, _, nbf = jax_case
    jm = np.asarray(interpret(
        functools.partial(jax_groupmin_kernel, tile_n=TILE_J), q, x, nbf,
        pl.BlockSpec((TILE_J // 128, Q_J), lambda i: (i, 0)),
        jax.ShapeDtypeStruct((N_J // 128, Q_J), jnp.float32)))
    atol = tol(q, x, nbf)
    np.testing.assert_allclose(GV.groupmin_width(q, x, nbf, 128).numpy(), jm, rtol=0, atol=atol)
    for chunk in GV.CHUNKS:
        np.testing.assert_allclose(GV.groupmin_chunked(q, x, nbf, chunk).numpy(), jm, rtol=0,
                                   atol=atol)


# ---------------------------------------------------------------------------
# The ported scripts and the bench twin, on the CPU at tiny sizes
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--n", "3001", "--q", "16", "--iters", "2"]


def test_bench_twin_prints_bench_py_keys(capsys):
    assert bench.main(TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert sorted(out) == sorted([
        "metric", "value", "unit", "vs_baseline", "recall_at_10_vs_float64",
        "exactness_certified_frac", "store_dtype", "elapsed_s", "backend"])
    assert out["backend"] == "cpu" and out["store_dtype"] == "bfloat16" and out["unit"] == "qps"
    assert out["metric"] == "exact_knn_qps_3001_d128_k10_single_chip"
    assert out["vs_baseline"] == round(out["value"] / 12_500, 3)
    assert out["exactness_certified_frac"] == 1.0 and out["recall_at_10_vs_float64"] >= 0.9


def test_bench_twin_never_picks_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--n", "100", "--q", "2", "--iters", "1"])


def test_store_and_queries_are_bench_py_draws():
    """The same generator sequence as bench.py: rows, then (iters, Q, d) queries."""
    rng = np.random.default_rng(0)
    xh = rng.standard_normal((300, 128)).astype(np.float32)
    qh = rng.standard_normal((2, 5, 128)).astype(np.float32)
    store = common.make_store(300, 128, seed=0, device="cpu")
    assert np.array_equal(store.x32.numpy(), xh)
    assert torch.equal(store.x, torch.from_numpy(xh).to(torch.bfloat16))
    assert np.array_equal(common.queries(store, 2, 5).numpy(), qh)


@pytest.mark.parametrize("script", [rescore_variants2, sweep_chunked, subgroup_proto,
                                    subgroup_variants])
def test_ported_script_runs_on_cpu(script, capsys):
    assert script.main(TINY) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    if script is sweep_chunked:
        assert [ln.split(":")[0] for ln in lines] == [
            "sweep current", "sweep chunk=512", "sweep chunk=1024"]
    elif script is rescore_variants2:
        assert len(lines) == 5 and all("recall@10=1.000" in ln for ln in lines)
    else:
        rows = [json.loads(ln) for ln in lines]
        assert len(rows) == (2 if script is subgroup_proto else 4)
        assert all(r["recall@10"] == 1.0 for r in rows)


def test_script_searches_equal_the_production_search():
    """Each prototype search is exact over the bf16 store: the ids of the
    production two-phase search with the same norms."""
    store = common.make_store(5000, 128, seed=0, device="cpu")
    x, nf32 = store.x, store.norms_f32_rows()
    q = common.queries(store, 1, 12)[0]
    _, want = T.topk_twophase(q, x, 10, "l2", x_norms=nf32)
    for name, fn in (*rescore_variants2.searches(x, nf32), *subgroup_proto.searches(x, nf32),
                     *subgroup_variants.searches(x, nf32)):
        d, i = fn(q)
        assert torch.equal(i, want), name
        assert (d[:, 1:] >= d[:, :-1]).all(), name

"""The f32 phase 1 and phase 2 of the port's flat search on tensor cores
with a 3xTF32 split, beyond ``F32_CUDA_CORE_MAX_Q`` queries over rows of
whole 16-byte units (image_search_engine_tpu_torch/ops/topk.py
``groupmin``, ``rescore``, ``wgmma_plan``, ``tf32_split``;
``csrc/groupmin_tf32.cu``, one warpgroup-MMA kernel for both phases), and
``chip_smoke.assert_same_topk``.

The kernel runs only on the card, where ``chip_smoke.py`` holds it to its
plain versions within ``score_tol`` and phase 1 to phase 2 bit for bit.
Here:

  (a) the warpgroup-MMA kernel's plan (``wgmma_plan``): the smallest of
      the 16/32/64/128-query tiles that holds min(Q, 128) queries, about
      one block an SM, every (query, group) pair covered by exactly one
      phase-1 block; the tensor-core tile plan (``mma_plan``) stays bf16
      and int8 only;
  (b) the routing, with a fake kernel library and ``_on_cuda`` patched: an
      f32 batch of up to ``F32_CUDA_CORE_MAX_Q`` queries, or over rows of
      no whole 16-byte units or at a misaligned address, reaches the
      CUDA-core entry points in both phases, a larger one over whole
      16-byte rows both warpgroup-MMA entry points on one query tile and
      the queries' tf32 halves; bf16 and int8 keep their kernels; a
      non-zero return code raises;
  (c) the kernel's summation structure on the CPU (``tf32_split``: hi and
      lo = tf32 rounded to nearest; per stage of 4 k-steps the products
      lo.hi, hi.lo, hi.hi of each 8-deep k-step added to a zeroed sum; one
      f32 add of each sum into the row's), each product exact and each sum
      rounded to nearest in f32, against a float64 product within
      ``chip_smoke.score_tol``, at d = 16, 130 and 2048, on rows of both
      signs, of one sign and scaled by 10. The tensor cores round their own
      sums otherwise, so this checks the structure's error, not the card's
      bits (``chip_smoke.py`` checks those);
  (d) those emulated scores through the port's plain select and finish
      against the JAX package's ``topk_twophase`` in interpret mode at Q =
      17, d = 130, N = 129 (every group rescored) and 5000: ids equal but
      at near-ties, distances within rtol 1e-5 / atol 1e-4, certificates
      equal and true;
  (e) ``assert_same_topk``: ids in both lists pass wherever they sit, an id
      in one list only passes only within the tolerance of that list's
      k-th distance, and distances are compared row for row.
"""

import contextlib
import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_search_engine_tpu.ops.topk_pallas import topk_twophase as jax_topk_twophase
from image_search_engine_tpu_torch.ops import _kernels
from image_search_engine_tpu_torch.ops import topk as T
from test_torch_port_groupmin_mma import assert_covers_once, assert_topk_match

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq", [T.F32_CUDA_CORE_MAX_Q + 1, 16, 17, 64, 129, 4096])
@pytest.mark.parametrize("n,sms", [(1, 132), (129, 132), (5000, 132), (10 ** 6, 132), (5000, 7)])
def test_wgmma_plan_covers_every_pair_once(nq, n, sms):
    p = T.wgmma_plan(nq, n, sms)
    assert p.bq in T._TF32_BQ and p.bq >= min(nq, 128) and 1 <= p.gps <= p.ngroups
    assert p.grid <= max(sms, p.nqt) + p.nqt  # about one block an SM
    if p.grid <= 4096:
        assert_covers_once(p)


@pytest.mark.parametrize("nq,bq", [(3, 16), (16, 16), (17, 32), (64, 64), (65, 128), (4096, 128)])
def test_wgmma_plan_at_the_corpus_shape(nq, bq):
    # over 1M rows on 132 SMs: the smallest tile that holds the batch (128
    # at most), 7,813 groups in slices that give each SM about one block
    w = T.wgmma_plan(nq, 10 ** 6, 132)
    assert w.bq == bq and w.nqt == -(-nq // bq)
    assert w.gps == -(-T.num_groups(10 ** 6) * w.nqt // 132) and w.grid <= 132 + w.nqt
    if nq == 64:
        assert (w.gps, w.grid) == (60, 131)


@pytest.mark.parametrize("nq,n,sms", [(0, 10, 132), (4, 0, 132), (4, 10, 0)])
def test_plans_raise_on_shapes_they_cannot_take(nq, n, sms):
    with pytest.raises(ValueError):
        T.wgmma_plan(nq, n, sms)
    with pytest.raises(ValueError):  # the tile plan is bf16's and int8's only
        T.mma_plan(max(nq, 1), max(n, 1), 16, itemsize=4)


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
    def install(rc=0):
        lib = FakeLibrary(rc)
        monkeypatch.setattr(_kernels, "library", lambda: lib)
        monkeypatch.setattr(T, "_on_cuda", lambda *ts: True)
        monkeypatch.setattr(T, "_stream", lambda t: 0)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev: SimpleNamespace(multi_processor_count=132))
        return lib
    return install


def inputs(dtype, nq, n=300, d=130, t=3):
    g = torch.Generator().manual_seed(nq)
    x = torch.randn(n, d, generator=g).to(dtype)
    q = torch.randn(nq, d, generator=g).to(dtype)
    norms = (x.float() ** 2).sum(1)
    cand = torch.randint(0, T.num_groups(n), (nq, t), generator=g, dtype=torch.int32)
    return q, x, norms, cand


def launch(q, x, norms, cand):
    T.reset_launch_counts()
    mins = T.groupmin(q, x, norms)
    scores = T.rescore(q, x, norms, cand)
    return mins, scores


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """x's values at an address 4 bytes past a 16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype)[1:]
    return flat.view(x.shape).copy_(x)


CUDA_CORES = ("ise_groupmin", "ise_rescore")
TF32 = ("ise_groupmin_tf32", "ise_rescore_tf32")
BF16 = ("ise_groupmin_mma", "ise_rescore_mma")


@pytest.mark.parametrize("nq,dtype,d,rows,entries", [
    (1, torch.float32, 128, "aligned", CUDA_CORES),
    (T.F32_CUDA_CORE_MAX_Q, torch.float32, 128, "aligned", CUDA_CORES),
    (T.F32_CUDA_CORE_MAX_Q + 1, torch.float32, 128, "aligned", TF32),
    (17, torch.float32, 128, "aligned", TF32),
    (200, torch.float32, 16, "aligned", TF32),
    (17, torch.float32, 130, "aligned", CUDA_CORES),  # rows of no whole 16-byte units
    (17, torch.float32, 128, "misaligned", CUDA_CORES),
    (1, torch.bfloat16, 130, "aligned", BF16),
    (17, torch.bfloat16, 130, "aligned", BF16),
])
def test_both_phases_take_one_route(fake_cuda, nq, dtype, d, rows, entries):
    lib = fake_cuda()
    q, x, norms, cand = inputs(dtype, nq, d=d)
    if rows == "misaligned":
        x = misaligned(x)
    mins, scores = launch(q, x, norms, cand)
    assert tuple(c[0] for c in lib.calls) == entries
    assert (T.groupmin.launches, T.rescore.launches) == (1, 1)
    on_tc = int(entries != CUDA_CORES)
    assert (T.groupmin.tensor_core_launches, T.rescore.tensor_core_launches) == (on_tc, on_tc)
    gm, rs = lib.calls[0][1], lib.calls[1][1]
    if entries == TF32:
        w = T.wgmma_plan(nq, 300, 132)
        # x, qhi, qlo, norms, out, nq, n, d, bq, gps, stream
        assert gm[0] == x.data_ptr() and gm[3:10] == (norms.data_ptr(), mins.data_ptr(), nq,
                                                     300, d, w.bq, w.gps)
        # x, qhi, qlo, norms, cand, out, nq, n, d, t, bq, stream: phase 1's query tile
        assert rs[0] == x.data_ptr() and rs[3:11] == (norms.data_ptr(), cand.data_ptr(),
                                                     scores.data_ptr(), nq, 300, d, 3, w.bq)
        assert all(p % 16 == 0 for p in gm[1:3] + rs[1:3])
    elif entries == BF16:
        p = T.mma_plan(nq, 300, d)
        assert gm[4:14] == (nq, 300, d, p.bq, p.dp, p.kc, p.gps, int(p.resident), p.smem,
                            T._vec_mma(q, x))
        assert rs[5:13] == (nq, 300, d, 3, p.dp, p.rescore_kc, p.rescore_smem, T._vec_mma(q, x))
    else:
        assert gm[4:9] == (nq, 300, d, T._query_tile(nq, d * 4), T._vec(x))
        assert rs[5:10] == (nq, 300, d, 3, T._vec(x))


def test_the_queries_tf32_halves_reach_both_phases(fake_cuda, monkeypatch):
    lib = fake_cuda()
    q, x, norms, cand = inputs(torch.float32, 17, d=128)
    halves = []
    split = T.tf32_split

    def spy(v):
        halves.append(split(v))
        return halves[-1]
    monkeypatch.setattr(T, "tf32_split", spy)
    launch(q, x, norms, cand)
    (hi, lo), (hi2, lo2) = halves
    assert torch.equal(hi, hi2) and torch.equal(lo, lo2) and torch.equal(hi, split(q)[0])
    assert lib.calls[0][1][1:3] == (hi.data_ptr(), lo.data_ptr())
    assert lib.calls[1][1][1:3] == (hi2.data_ptr(), lo2.data_ptr())


@pytest.mark.parametrize("nq", [1, T.F32_CUDA_CORE_MAX_Q + 1])
def test_int8_keeps_its_kernels(fake_cuda, nq):
    lib = fake_cuda()
    q, x, norms, cand = inputs(torch.float32, nq)
    qi, qs = T.quantize_int8(q)
    xi, xs = T.quantize_int8(x)
    T.groupmin_q8(qi, qs, xi, xs, norms)
    T.rescore_q8(qi, qs, xi, xs, norms, cand)
    want = "ise_groupmin_q8" if nq <= T.DP4A_MAX_Q else "ise_groupmin_q8_mma"
    assert [c[0] for c in lib.calls] == [want, "ise_rescore_q8"]


@pytest.mark.parametrize("which", ["groupmin", "rescore"])
def test_a_failed_f32_tensor_core_launch_raises(fake_cuda, which):
    fake_cuda(rc=1)
    q, x, norms, cand = inputs(torch.float32, T.F32_CUDA_CORE_MAX_Q + 1)
    T.reset_launch_counts()
    with pytest.raises(RuntimeError, match=f"{which} kernel launch failed"):
        if which == "groupmin":
            T.groupmin(q, x, norms)
        else:
            T.rescore(q, x, norms, cand)
    assert getattr(T, which).launches == 0 and getattr(T, which).tensor_core_launches == 0


# ---------------------------------------------------------------------------
# (c) the kernel's arithmetic, emulated
# ---------------------------------------------------------------------------


#: k-steps of 8 values per stage of the kernel, summed before one f32 add
STAGE_STEPS = 4


def kernel_split(v: np.ndarray):
    """``tf32_split``, as float64 for exact products."""
    return tuple(h.numpy().astype(np.float64) for h in T.tf32_split(torch.from_numpy(v)))


def emulated_scores(q: np.ndarray, x: np.ndarray, norms: np.ndarray) -> np.ndarray:
    """(Q, N) f32 ``fmaf(-2, dot, norm)`` with the kernel's summation
    structure: d zero-padded to 8-value k-steps; per stage of 4 k-steps,
    each step's lo.hi, hi.lo and hi.hi (8 exact products each) added in
    that order to a zeroed sum, then one f32 add of the sum into the row's.
    Each partial sum here is rounded to nearest in f32; the tensor cores
    round theirs otherwise, so these are not the card's bits, only a model
    of the structure's error."""
    pad = (-q.shape[1]) % 8
    qh, ql = kernel_split(np.pad(q, ((0, 0), (0, pad))))
    xh, xl = kernel_split(np.pad(x, ((0, 0), (0, pad))))
    acc = np.zeros((q.shape[0], x.shape[0]), np.float32)
    step = 8 * STAGE_STEPS
    for s0 in range(0, qh.shape[1], step):
        part = np.zeros_like(acc)
        for s in range(s0, min(s0 + step, qh.shape[1]), 8):
            k = slice(s, s + 8)
            for a, b in ((qh, xl), (ql, xh), (qh, xh)):
                part = (part + a[:, k] @ b[:, k].T).astype(np.float32)
        acc = (acc + part).astype(np.float32)
    return (norms[None, :].astype(np.float64) - 2.0 * acc).astype(np.float32)


@pytest.mark.parametrize("d", [16, 130, 2048])
@pytest.mark.parametrize("rows", ["both signs", "one sign", "scaled by 10"])
def test_emulated_product_within_score_tol(d, rows):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((64, d)).astype(np.float32)
    q = rng.standard_normal((4, d)).astype(np.float32)
    if rows == "one sign":  # post-ReLU embeddings: every product adds the same way
        x, q = np.abs(x), np.abs(q)
        q[0] = x[5]  # a query on a store row
    elif rows == "scaled by 10":
        x *= 10
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32)
    got = emulated_scores(q, x, norms)
    truth = norms[None, :].astype(np.float64) - 2.0 * q.astype(np.float64) @ x.astype(np.float64).T
    tol = chip_smoke.score_tol(torch.from_numpy(q), torch.from_numpy(norms))
    assert np.abs(got - truth).max() <= tol


# ---------------------------------------------------------------------------
# (d) the search, on the emulated scores, against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,metric", [(129, "l2"), (5000, "ip")])
def test_emulated_twophase_matches_jax(n, metric):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 130)).astype(np.float32)
    q = rng.standard_normal((17, 130)).astype(np.float32)
    k = 10
    qf = q * (0.5 if metric == "ip" else 1.0)
    norms = (x.astype(np.float64) ** 2).sum(1).astype(np.float32) if metric == "l2" else \
        np.zeros(n, np.float32)
    scores = torch.from_numpy(emulated_scores(qf, x, norms))
    ng = T.num_groups(n)
    mins = torch.nn.functional.pad(scores, (0, ng * T.GROUP - n), value=float("inf")).view(
        17, ng, T.GROUP).amin(2)
    t = min(k + 4, ng)
    if t < ng:
        vals, cand = T.select_topt_ref(mins, t)
        threshold = vals[:, -1]
    else:
        cand = torch.arange(ng, dtype=torch.int32).expand(17, ng).contiguous()
        threshold = torch.full((17,), float("inf"))
    valid, safe = T._candidate_rows(cand, n)
    cscores = torch.where(valid, torch.gather(scores, 1, safe), torch.tensor(float("inf")))
    # one routine in both phases: each selected group's min is its rows' min
    assert torch.equal(cscores.view(17, t, -1).amin(2), torch.gather(mins, 1, cand.long()))
    pd, pi, pc = T.finish_candidates(torch.from_numpy(q), cscores, cand, threshold, k, metric,
                                     True)
    jd, ji, jc = jax_topk_twophase(jnp.asarray(q), jnp.asarray(x), k, metric, tile_n=1024,
                                   with_certificate=True, interpret=True)
    assert_topk_match(pd.numpy(), pi.numpy(), np.asarray(jd), np.asarray(ji))
    np.testing.assert_array_equal(pc.numpy(), np.asarray(jc))
    assert pc.all()


# ---------------------------------------------------------------------------
# (e) assert_same_topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,d,i,rd,ri,ok", [
    # id 13 is in both lists; within tol of the k-th distance in the tested
    # list, not in the reference
    ("shared id at the boundary", [1, 2, 3, 4.999, 5], [10, 11, 12, 13, 14],
     [1, 2, 3, 4.9975, 5], [10, 11, 12, 13, 14], True),
    ("near-tie swap at the k-th place", [1, 2, 3, 4, 5.001], [10, 11, 12, 13, 15],
     [1, 2, 3, 4, 5], [10, 11, 12, 13, 14], True),
    ("missing id well inside the top k", [1, 2, 3, 4, 5], [10, 11, 16, 13, 14],
     [1, 2, 3, 4, 5], [10, 11, 12, 13, 14], False),
    ("reference id well inside the top k missing", [1, 2, 3, 4, 4.0005], [10, 11, 13, 14, 15],
     [1, 2, 3, 4, 4.0005], [10, 11, 12, 13, 14], False),
    ("distance off by more than tol", [1, 2, 3.01, 4, 5], [10, 11, 12, 13, 14],
     [1, 2, 3, 4, 5], [10, 11, 12, 13, 14], False),
])
def test_assert_same_topk(case, d, i, rd, ri, ok):
    args = [np.array([v]) for v in (d, i, rd, ri)]
    if ok:
        chip_smoke.assert_same_topk(*args, 2e-3, case)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_same_topk(*args, 2e-3, case)

"""Phase-2 tuning, round 3: the margin validated at scale, and an int8
store rescored on its codes.

    python -m image_search_engine_tpu_torch.benchmarks.rescore_variants3
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/rescore_variants3.py``. Two searches,
each a production phase-1 kernel and the select (CUDA kernels), then a
gather and rescore in torch (an XLA einsum there):

  * :func:`twophase_bf16` (its :79): ``rescore_variants.twophase_var`` with
    the bf16 rescore, at t = k and k + 1;
  * :func:`twophase_int8` (its :122): the query quantized per row as the
    JAX script does (max|q| / 127, round half to even, clip to +-127:
    ``ops.topk.quantize_int8``), ``ops.topk.groupmin_q8`` over the int8
    codes (the int8 tensor-core sweep beyond 4 queries), then the exact
    int32 cross term of the gathered codes (an f32 product of int8 values
    is exact while d * 127^2 < 2^24) and the script's epilogue cn - 2 *
    (cross * (sq * scale)), at t = k + 1 and k + 2. That is production's
    norms - cross * ((2 sq) * scale) bit for bit (doubling is exact), so
    the ids equal ``topk_twophase``'s over the same int8 store at the same
    margin.

Same data as the JAX script: seed 0, 1M x 128 standard-normal rows; the
bf16 store with the norms of the f32 rows; the int8 store quantized per
row (``quantize_int8``, the JAX formula) with the norms of its dequantized
rows; 20 dispatches of Q = 2048 f32 queries, k = 10. Prints the four
searches' ms per dispatch (CUDA events), QPS and recall@10 against float64
on 8 queries, whether the int8 searches' ids equal ``topk_twophase``'s on
the first dispatch, then t = k + 0 and k + 1 against t = k + 4 over every
dispatched query (40,960): true mismatches (a covering group dropped)
apart from boundary ties (``common.margin_split``).
"""

from __future__ import annotations

import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.benchmarks.rescore_variants import twophase_var
from image_search_engine_tpu_torch.ops.topk import (GROUP, groupmin_q8, quantize_int8,
                                                    select_topt, topk_twophase)

N, D, Q, K, ITERS = common.N, common.D, 2048, 10, 20
WIDE = 4  # the margin the tight ones are validated against
INT8_EXACT_D = (1 << 24) // (127 * 127)  # widest rows whose int8 sums are exact in f32


def twophase_bf16(q, x, xn, *, t_margin: int, k: int = K):
    """The bf16 search with the bf16 rescore: (distances, ids)."""
    return twophase_var(q, x, xn, t_margin=t_margin, bf16_rescore=True, k=k)


def twophase_int8(q, codes, scales, xn, *, t_margin: int, k: int = K):
    """The int8 search rescored on the codes: (distances, ids)."""
    n, d = codes.shape
    if d > INT8_EXACT_D:
        raise ValueError(f"d={d}: int8 sums past 2^24 are not exact in f32")
    qi, sq = quantize_int8(q)
    mins = groupmin_q8(qi, sq, codes, scales, xn)  # (Q, ngroups)
    _, cand = select_topt(mins, min(k + t_margin, mins.shape[1]))
    rows = common.block_rows(cand, GROUP)
    safe = rows.clamp(0, n - 1)
    cross = torch.bmm(codes[safe].float(), qi.float()[:, :, None])[:, :, 0]  # exact integers
    dist = xn[safe] - 2.0 * (cross * (sq[:, None] * scales[safe]))
    dist = torch.where(rows < n, dist, torch.full_like(dist, float("inf")))
    vals, ids = common.best_rows(dist, cand, GROUP, k)
    return common.finish_l2(q, vals), ids


def int8_store(store: common.Store):
    """(codes, scales, norms of the dequantized rows) of the store's f32 rows."""
    codes, scales = quantize_int8(store.x32)
    deq = codes.float() * scales[:, None]
    return codes, scales, (deq * deq).sum(1)


def searches(x, xn, codes, scales, xn8):
    """(name, fn(q) -> (distances, ids)) of the JAX script's four timed lines."""
    return [("bf16 t=k+0", lambda q: twophase_bf16(q, x, xn, t_margin=0)),
            ("bf16 t=k+1", lambda q: twophase_bf16(q, x, xn, t_margin=1)),
            ("int8 t=k+1 int8-rescore",
             lambda q: twophase_int8(q, codes, scales, xn8, t_margin=1)),
            ("int8 t=k+2 int8-rescore",
             lambda q: twophase_int8(q, codes, scales, xn8, t_margin=2))]


def validate(x, xn, qs, margins=(0, 1)) -> dict:
    """{margin: common.margin_counts} of the bf16 search at each margin
    against t = k + WIDE over every dispatch of ``qs``."""
    truth = lambda q: twophase_bf16(q, x, xn, t_margin=WIDE)  # noqa: E731
    return {m: common.margin_counts(lambda q, m=m: twophase_bf16(q, x, xn, t_margin=m), truth, qs)
            for m in margins}


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    torch.backends.cuda.matmul.allow_tf32 = False
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_f32_rows()
    codes, scales, xn8 = int8_store(store)
    qs = common.queries(store, args.iters, args.q)
    ref = common.float64_topk_ids(qs[0][:8], store.x32, K)
    for name, fn in searches(x, xn, codes, scales, xn8):
        print(common.timed(name, fn, qs, ref), flush=True)
    for m in (1, 2):
        _, want = topk_twophase(qs[0], codes, K, "l2", x_norms=xn8, x_scale=scales, t_margin=m)
        same = torch.equal(twophase_int8(qs[0], codes, scales, xn8, t_margin=m)[1], want)
        print(f"int8 t=k+{m}: ids = topk_twophase's over the int8 store: {same}", flush=True)
    for m, c in validate(x, xn, qs).items():
        print(f"validation t=k+{m} vs t=k+{WIDE} over {c['queries']} queries: "
              f"{c['mismatches']} real mismatches, {c['ties']} boundary ties", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

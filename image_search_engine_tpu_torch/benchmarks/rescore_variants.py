"""Phase-2 tuning, round 1: the rescore's operand types and the margin.

    python -m image_search_engine_tpu_torch.benchmarks.rescore_variants
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/rescore_variants.py``. Its question was
XLA's on the TPU: an f32 query against the gathered bf16 candidates made
XLA upcast and materialize the (Q, t*128, d) candidates in f32, where a
bf16 x bf16 -> f32 rescore over the bf16 store is the same function (a bf16
product is exact in f32) without that copy. Its ``twophase_var`` (:78)
runs production's phase-1 kernel, then ``lax.top_k`` of the t = k + margin
best groups, a gather and an XLA einsum. Here (:func:`twophase_var`)
phase 1 is ``ops.topk.groupmin`` (the bf16 tensor-core sweep), the select
``ops.topk.select_topt`` (both CUDA kernels; the select's (value, group)
order is ``lax.top_k``'s), and the gather and rescore run in torch, as XLA
ran them there: the f32 query in f32 with TF32 off (the einsum's
``Precision.HIGHEST``), or an f32 product of the bf16 values, the bf16 x
bf16 -> f32 einsum's function (``torch.bmm`` of bf16 tensors would round
its output to bf16).

Same data as the JAX script: seed 0, 1M x 128 standard-normal rows stored
as bf16 with the norms of the f32 rows, 20 dispatches of Q = 2048 f32
queries, k = 10. Prints v0 (production ``topk_twophase`` at its default
margin 4), v1 (the bf16 rescore at t = k + 4) and v2 (t = k + 2): ms per
dispatch (CUDA events), QPS, and recall@10 against float64 on 8 queries.
"""

from __future__ import annotations

import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.topk import GROUP, groupmin, select_topt, topk_twophase

N, D, Q, K, ITERS = common.N, common.D, 2048, 10, 20


def twophase_var(q, x, xn, *, t_margin: int, bf16_rescore: bool, k: int = K):
    """The two-phase search with its phase 2 in torch: (distances, ids).
    ``bf16_rescore`` scores the bf16 query, else the f32 one (TF32 must be
    off, as ``main`` sets it, for a true f32 product)."""
    qf = q.to(torch.bfloat16).contiguous()
    mins = groupmin(qf, x, xn)  # (Q, ngroups)
    _, cand = select_topt(mins, min(k + t_margin, mins.shape[1]))
    vals, ids = common.rescore_blocks(qf if bf16_rescore else q, x, xn, cand, GROUP, k)
    return common.finish_l2(q, vals), ids


def searches(x, xn):
    """(name, fn(q) -> (distances, ids)) of the JAX script's three lines."""
    return [("v0 current", lambda q: topk_twophase(q, x, K, "l2", x_norms=xn)),
            ("v1 bf16-rescore t=k+4",
             lambda q: twophase_var(q, x, xn, t_margin=4, bf16_rescore=True)),
            ("v2 bf16-rescore t=k+2",
             lambda q: twophase_var(q, x, xn, t_margin=2, bf16_rescore=True))]


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    torch.backends.cuda.matmul.allow_tf32 = False
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_f32_rows()
    qs = common.queries(store, args.iters, args.q)
    ref = common.float64_topk_ids(qs[0][:8], store.x32, K)
    for name, fn in searches(x, xn):
        print(common.timed(name, fn, qs, ref), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

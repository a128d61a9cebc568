"""Phase 2 with the norms left out of the kernel: production against
cross-only.

    python -m image_search_engine_tpu_torch.benchmarks.rescore_dma_variants
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/rescore_dma_variants.py``. On the TPU
each grid step of the fused rescore issued one copy per candidate group and
one per candidate group's norms; the "cross-only" variant dropped the norm
copies. Here its phase 2 is ``ops.rescore_variants.rescore_cross`` (CUDA),
which reads each picked row once and writes the raw cross products q.x (0
past N); the norms are gathered outside the kernel, PAD_NORM past N, and
added in the epilogue, cn - 2 q.x. Phase 1 is the production ``groupmin``
and a stable select of t = min(k + margin, ngroups) groups.

Same data as the JAX script: seed 0, 1M x 128 bf16 store with the norms of
the bf16 rows, Q = 2048, k = 10, margin 2, QB = 8, 20 dispatches. Prints the
count of queries whose id sets differ from the production search's
(``topk_twophase`` at margin 2) over the first dispatch, then each search's
best of three timed runs (ms per dispatch by CUDA events, QPS) with its
recall@10 against float64 over the first dispatch.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.ops.rescore_variants import rescore_cross
from image_search_engine_tpu_torch.ops.topk import GROUP, groupmin, topk_twophase
from image_search_engine_tpu_torch.parallel.topk import PAD_NORM

N, D, Q, K, ITERS, TILE_N, MARGIN, QB = common.N, common.D, 2048, 10, 20, 4096, 2, 8
REPEATS = 3  # timed runs per search; the best counts


def twophase_cross_only(q, x, k: int, *, x_norms, tile_n=None, t_margin: int, qb: int):
    """The bf16 l2 two-phase search with the cross-only phase 2: (distances
    (Q, k'), ids (Q, k')), k' = min(k, t*128). Candidate rows past N score
    PAD_NORM (their norm; their cross product is 0), so N < k returns such
    rows, at distance 1e30, as the JAX script does. ``tile_n`` (the TPU
    sweep's VMEM tile) is accepted and ignored."""
    n = x.shape[0]
    qf = q.to(torch.bfloat16).contiguous()
    mins = groupmin(qf, x, x_norms)
    ng = mins.shape[1]
    t = min(k + t_margin, ng)
    _, cand = stable_smallest(mins, t)
    cand = cand.to(torch.int32).contiguous()
    cross = rescore_cross(qf, x, cand, qb=qb)
    norms = F.pad(x_norms, (0, ng * GROUP - n), value=PAD_NORM)
    cn = norms.view(ng, GROUP)[cand.long()].reshape(q.shape[0], t * GROUP)
    vals, ids = common.best_rows(cn - 2.0 * cross, cand, GROUP, min(k, t * GROUP))
    return common.finish_l2(q, vals), ids


def searches(x, xn):
    """(name, fn(q) -> (distances, ids)): production, then cross-only."""
    return (("production", lambda q: topk_twophase(q, x, K, "l2", x_norms=xn, t_margin=MARGIN)),
            ("cross-only", lambda q: twophase_cross_only(q, x, K, x_norms=xn, tile_n=TILE_N,
                                                         t_margin=MARGIN, qb=QB)))


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_bf16_rows()
    qs = common.queries(store, args.iters, args.q)
    (_, prod), (_, var) = runs = searches(x, xn)
    mism = int((~common.same_id_sets(prod(qs[0])[1], var(qs[0])[1])).sum())
    print(f"variant vs production id-set mismatches: {mism} / {args.q}", flush=True)
    ref = common.float64_topk_ids(qs[0], store.x32, K)
    for name, fn in runs:
        common.first_call(fn, qs[0])
        best = min(max(common.time_dispatches(fn, qs), 1e-9) for _ in range(REPEATS))
        print(f"{name}: {best / args.iters * 1e3:.2f} ms/dispatch, "
              f"{args.iters * args.q / best / 1e3:.1f}k QPS, "
              f"recall@10={common.recall(fn(qs[0])[1], ref):.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

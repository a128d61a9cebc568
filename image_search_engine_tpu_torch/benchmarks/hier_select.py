"""A hierarchical candidate select: two small top-ks instead of one wide one.

    python -m image_search_engine_tpu_torch.benchmarks.hier_select
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/hier_select.py``. The covering argument
nests: a supergroup of 8 groups that holds one of the k nearest has a
minimum <= the k-th distance, and at most k supergroups can, so the k + 4
best supergroups, then the k + 2 best of their 64 group mins, cover the
exact answer. The select runs in stable torch sorts (ties to the lowest
position, as ``lax.top_k``); phases 1 and 2 are the production kernels
(``groupmin``, ``rescore``). No new kernel.

Same data as the JAX script: seed 0, 1M x 128 bf16 store with the norms of
the bf16 rows, Q = 2048, k = 10, 20 dispatches. Prints the count of queries
whose id sets differ from the production search's (``topk_twophase`` at
margin 2) over every dispatch, then both searches' ms per dispatch (CUDA
events) and QPS with their recall@10 against float64 over the first
dispatch.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.ops.topk import finish_candidates, groupmin, rescore, topk_twophase

N, D, Q, K, ITERS = common.N, common.D, 2048, 10, 20
SUP = 8  # groups per supergroup


def hier_candidates(mins: torch.Tensor, t: int, ts: int) -> torch.Tensor:
    """Per query, the ``ts`` best supergroups by their min, then the ``t``
    best of those supergroups' groups: mins (Q, ngroups) -> (Q, t) int32
    group ids, ascending by min."""
    nq, ng = mins.shape
    nsup = -(-ng // SUP)
    mp = F.pad(mins, (0, nsup * SUP - ng), value=float("inf")).view(nq, nsup, SUP)
    _, sup_idx = stable_smallest(mp.amin(2), ts)
    gmins = torch.gather(mp, 1, sup_idx[:, :, None].expand(-1, -1, SUP)).reshape(nq, ts * SUP)
    gids = (sup_idx[:, :, None] * SUP + torch.arange(SUP, device=mins.device)).reshape(nq, ts * SUP)
    _, pos = stable_smallest(gmins, t)
    return torch.gather(gids, 1, pos).to(torch.int32).contiguous()


def build(sup_margin: int, t_margin: int, k: int = K):
    """The two-phase search with the hierarchical select: fn(q, x, xn) ->
    (distances (Q, k), ids (Q, k))."""
    def fn(q, x, xn):
        qf = q.to(torch.bfloat16).contiguous()
        mins = groupmin(qf, x, xn)
        ng = mins.shape[1]
        cand = hier_candidates(mins, min(k + t_margin, ng), min(k + sup_margin, -(-ng // SUP)))
        return finish_candidates(q, rescore(qf, x, xn, cand), cand, None, k, "l2", False)

    return fn


def searches(x, xn):
    """(name, fn(q) -> (distances, ids)): production, then hierarchical."""
    hier = build(sup_margin=4, t_margin=2)
    return (("production m2", lambda q: topk_twophase(q, x, K, "l2", x_norms=xn, t_margin=2)),
            ("hier m'=4 m=2", lambda q: hier(q, x, xn)))


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_bf16_rows()
    qs = common.queries(store, args.iters, args.q)
    (_, prod), (_, hier) = runs = searches(x, xn)
    mism = sum(int((~common.same_id_sets(prod(q)[1], hier(q)[1])).sum()) for q in qs)
    print(f"hier(m'=4,m=2) vs production m2: {mism} / {args.iters * args.q} mismatches",
          flush=True)
    ref = common.float64_topk_ids(qs[0], store.x32, K)
    for name, fn in runs:
        print(common.timed(name, fn, qs, ref), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

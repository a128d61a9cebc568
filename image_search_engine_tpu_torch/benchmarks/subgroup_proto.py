"""Prototype: two-level candidate selection for the two-phase search.

    python -m image_search_engine_tpu_torch.benchmarks.subgroup_proto
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/subgroup_proto.py``. The production
phase 2 rescans t = k + 4 groups of 128 rows per query. Here phase 1
(``ops.groupmin_variants.groupmin_two_level``, CUDA) also emits the mins of
32-row subgroups, rounded to bf16 and query-major; the select narrows the
k + 4 best groups to the k + 4 best of their subgroups before the gather,
a quarter of the rows. Exactness argument per level: a group or subgroup
that holds a true top-k row has a min <= the k-th distance, and at most k
can, so the k + 4 best cover the answer (the margin absorbs the bf16 ties,
which the stable select breaks to the lowest position).

Same data as the JAX script: seed 0, 1M x 128 standard-normal rows stored
as bf16 with the norms of the f32 rows, k = 10, 20 dispatches at Q = 2048
and again at Q = 4096, against the production search ("shipped",
``topk_twophase`` at its default margin). Prints one JSON line per variant
and Q: QPS, ms per dispatch (CUDA events), recall@10 against float64 on 8
queries, and the first call's seconds. ``--q`` runs one Q.
"""

from __future__ import annotations

import json
import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.ops.groupmin_variants import SUB, groupmin_two_level
from image_search_engine_tpu_torch.ops.topk import GROUP, topk_twophase

N, D, K, ITERS = common.N, common.D, 10, 20
Q_BATCHES = (2048, 4096)


def topk_two_level(q, x, k, x_norms, *, layout: str = "v1", t2_margin: int = 4):
    """The two-level search: t1 = k + 4 groups by their f32 mins, then the
    t2 = k + ``t2_margin`` best of their subgroups by the bf16 mins, then
    those subgroups' rows rescored exactly. Returns (distances, ids)."""
    qf = q.to(torch.bfloat16).contiguous()
    gmins, smins = groupmin_two_level(qf, x, x_norms, layout)
    ngroups = gmins.shape[0]
    per = GROUP // SUB
    t1 = min(k + 4, ngroups)
    _, cand_groups = stable_smallest(gmins.T, t1)
    sub_ids = (cand_groups.long()[:, :, None] * per
               + torch.arange(per, device=q.device)).reshape(q.shape[0], per * t1)
    # the last group's subgroups past N have no min: +inf
    sub_vals = torch.gather(smins.float(), 1, sub_ids.clamp(max=smins.shape[1] - 1))
    sub_vals = torch.where(sub_ids < smins.shape[1], sub_vals, torch.full_like(sub_vals,
                                                                               float("inf")))
    t2 = min(k + t2_margin, per * t1)
    _, pos = stable_smallest(sub_vals, t2)
    cand_subs = torch.gather(sub_ids, 1, pos)
    vals, ids = common.rescore_blocks(qf, x, x_norms, cand_subs, SUB, k)
    return common.finish_l2(q, vals), ids


def searches(x, xn, k: int = K):
    """(variant, fn(q) -> (distances, ids)): the prototype and the shipped search."""
    return (("two_level", lambda q: topk_two_level(q, x, k, xn)),
            ("shipped", lambda q: topk_twophase(q, x, k, "l2", x_norms=xn)))


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=0, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_f32_rows()
    rng = store.query_rng()
    for q_batch in ((args.q,) if args.q else Q_BATCHES):
        qh = rng.standard_normal((args.iters, q_batch, D)).astype("float32")
        qs = torch.from_numpy(qh).to(args.device)
        ref = common.float64_topk_ids(qs[0][:8], store.x32, K)
        for name, fn in searches(x, xn):
            _, first_s = common.first_call(fn, qs[0])
            el = max(common.time_dispatches(fn, qs), 1e-9)
            print(json.dumps({
                "variant": name, "Q": q_batch, "qps": round(args.iters * q_batch / el, 1),
                "ms_per_sweep": round(1000 * el / args.iters, 2),
                "recall@10": common.recall(fn(qs[0])[1][:8], ref),
                "first_call_s": round(first_s, 1),
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

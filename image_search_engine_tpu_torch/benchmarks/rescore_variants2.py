"""Phase-2 tuning, round 2: the candidate group width and the margin.

    python -m image_search_engine_tpu_torch.benchmarks.rescore_variants2
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/rescore_variants2.py``. Phase 1 emits
the mins of G-row groups, G in {128, 64, 32} (``ops.groupmin_variants.
groupmin_width``, a CUDA kernel); phase 2 gathers the t = k + margin best
groups of G rows each and rescores them in torch, so its traffic scales
with t*G. The covering proof does not depend on the width: each of the k
nearest lives in a group whose min is <= the k-th distance, and at most k
groups can have such a min.

Same data as the JAX script: seed 0, 1M x 128 standard-normal rows stored
as bf16 with the norms of the f32 rows, Q = 2048, k = 10, 20 dispatches.
Prints, per variant and for the production search at t = k + 2: ms per
dispatch (CUDA events), QPS, and recall@10 against float64 on 8 queries.
"""

from __future__ import annotations

import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.ops.groupmin_variants import groupmin_width
from image_search_engine_tpu_torch.ops.topk import topk_twophase

N, D, Q, K, ITERS = common.N, common.D, 2048, 10, 20
VARIANTS = (("G=128 t=k+1", 1, 128), ("G=64  t=k+2", 2, 64), ("G=64  t=k+4", 4, 64),
            ("G=32  t=k+2", 2, 32))


def twophase_var(q, x, xn, *, t_margin: int, group: int, k: int = K):
    """The two-phase search with G-row groups: (distances, ids)."""
    qf = q.to(torch.bfloat16).contiguous()
    mins = groupmin_width(qf, x, xn, group)  # (ngroups, Q)
    t = min(k + t_margin, mins.shape[0])
    _, cand = stable_smallest(mins.T, t)
    vals, ids = common.rescore_blocks(qf, x, xn, cand, group, k)
    return common.finish_l2(q, vals), ids


def shipped(q, x, xn, k: int = K):
    return topk_twophase(q, x, k, "l2", x_norms=xn, t_margin=2)


def searches(x, xn):
    """(name, fn(q) -> (distances, ids)) for each variant and the production search."""
    out = [(name, lambda q, m=m, g=g: twophase_var(q, x, xn, t_margin=m, group=g))
           for name, m, g in VARIANTS]
    return out + [("production t=k+2", lambda q: shipped(q, x, xn))]


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_f32_rows()
    qs = common.queries(store, args.iters, args.q)
    ref = common.float64_topk_ids(qs[0][:8], store.x32, K)
    for name, fn in searches(x, xn):
        common.first_call(fn, qs[0])
        el = max(common.time_dispatches(fn, qs), 1e-9)
        r = common.recall(fn(qs[0])[1][:8], ref)
        print(f"{name}: {el / args.iters * 1e3:.2f} ms/dispatch, "
              f"{args.iters * args.q / el / 1e3:.1f}k QPS, recall@10={r:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

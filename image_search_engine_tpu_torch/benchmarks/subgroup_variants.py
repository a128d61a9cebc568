"""The two-level sweep's three output layouts, timed side by side.

    python -m image_search_engine_tpu_torch.benchmarks.subgroup_variants
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/subgroup_variants.py``, which looked for
a two-level kernel the TPU compiler accepts. The variants differ only in
how the 32-row subgroup mins leave the kernel
(``ops.groupmin_variants.groupmin_two_level``, CUDA):

  v1  query-major (Q, nsub), written from registers
  v2  query-major, staged in shared memory and written a query's run at a time
  v3  subgroup-major (nsub, Q), then a torch transpose

All narrow to t2 = k + 8 subgroups. Same data as the JAX script: seed 0, 1M
x 128 standard-normal rows stored as bf16 with the norms of the f32 rows,
Q = 2048, k = 10, 20 dispatches; the production search ("shipped") is timed
beside them. Prints one JSON line per variant: QPS, ms per dispatch (CUDA
events), recall@10 against float64 on 8 queries, the first call's seconds.
"""

from __future__ import annotations

import json
import sys

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.benchmarks.subgroup_proto import topk_two_level
from image_search_engine_tpu_torch.ops.groupmin_variants import LAYOUTS
from image_search_engine_tpu_torch.ops.topk import topk_twophase

N, D, K, ITERS, Q = common.N, common.D, 10, 20, 2048


def searches(x, xn, k: int = K):
    """(variant, fn(q) -> (distances, ids)) for each layout and the shipped search."""
    out = [(v, lambda q, v=v: topk_two_level(q, x, k, xn, layout=v, t2_margin=8))
           for v in LAYOUTS]
    return out + [("shipped", lambda q: topk_twophase(q, x, k, "l2", x_norms=xn))]


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_f32_rows()
    qs = common.queries(store, args.iters, args.q)
    ref = common.float64_topk_ids(qs[0][:8], store.x32, K)
    for name, fn in searches(x, xn):
        _, first_s = common.first_call(fn, qs[0])
        el = max(common.time_dispatches(fn, qs), 1e-9)
        print(json.dumps({
            "variant": name, "qps": round(args.iters * args.q / el, 1),
            "ms_per_sweep": round(1000 * el / args.iters, 2),
            "recall@10": common.recall(fn(qs[0])[1][:8], ref),
            "first_call_s": round(first_s, 1),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

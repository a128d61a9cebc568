"""The fused phase 2's queries per block (QB), and phase 1 alone.

    python -m image_search_engine_tpu_torch.benchmarks.gather_kernel_sweep
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/gather_kernel_sweep.py``; see
``gather_kernel_proto``. Times, on that script's data (seed 0, 1M x 128
bf16 store with the norms of the bf16 rows, Q = 2048, k = 10, 20
dispatches): phase 1 alone (group mins and the select of t = k + 2 groups),
then the fused search at margin 2 with QB = 16 and 32 queries per kernel
block and at margin 3 with QB = 16. Prints ms per dispatch (CUDA events)
and QPS, with each full search's recall@10 against float64 over the first
dispatch and phase 1's share of those true neighbours inside its
candidate groups.
"""

from __future__ import annotations

import sys

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.benchmarks.gather_kernel_proto import K, build
from image_search_engine_tpu_torch.ops.topk import GROUP

N, D, Q, ITERS, TILE_N = common.N, common.D, 2048, 20, 4096
VARIANTS = (("fused m2 QB=16", 2, 16), ("fused m2 QB=32", 2, 32), ("fused m3 QB=16", 3, 16))


def phase1(x, xn):
    """(name, fn(q) -> (candidate groups as f32, as int32), both (Q, t))."""
    fn = build(x.shape[0], x.shape[1], TILE_N, 2, phase1_only=True)
    return "phase1-only m2", lambda q: fn(q, x, xn)


def searches(x, xn):
    """(name, fn(q) -> (distances, ids)) for each QB and margin."""
    out = []
    for name, m, qb in VARIANTS:
        fn = build(x.shape[0], x.shape[1], TILE_N, m, QB=qb)
        out.append((name, lambda q, fn=fn: fn(q, x, xn)))
    return out


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_bf16_rows()
    qs = common.queries(store, args.iters, args.q)
    ref = common.float64_topk_ids(qs[0], store.x32, K)
    name, fn = phase1(x, xn)
    cover = common.group_recall(fn(qs[0])[1], ref, GROUP)
    print(f"{common.timed(name, fn, qs)}, true top-10 in the candidates={cover:.5f}", flush=True)
    for name, fn in searches(x, xn):
        print(common.timed(name, fn, qs, ref), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Prototype: phase 2's candidate gather and rescore as one kernel.

    python -m image_search_engine_tpu_torch.benchmarks.gather_kernel_proto
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/gather_kernel_proto.py``. There, the
shipped phase 2 gathered the candidate groups into a (Q, t*128, d) buffer
and rescanned it; the prototype fused both, each grid step reading one
candidate group per query of a block of QB straight from the store. Here
phase 1 is the production ``groupmin`` (CUDA) on the caller's norms and a
stable select of the t = k + margin best groups (as ``lax.top_k``); phase 2
is ``ops.rescore_variants.rescore_gather`` (CUDA), which reads each picked
row once in place and takes its squared norm from the bf16 row itself.

Same data as the JAX script: seed 0, 1M x 128 standard-normal rows stored
as bf16 with the norms of the bf16 rows, Q = 2048, k = 10, margin 2, 20
dispatches. Prints the agreement of the fused search's id sets with the
production search's (``topk_twophase`` at margin 2), both searches'
recall@10 against float64 over the first dispatch, the margin validation
(margins 2 and 3 against 6 over every dispatch) and the fused search's time
per dispatch (CUDA events).
"""

from __future__ import annotations

import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.ops.rescore_variants import rescore_gather
from image_search_engine_tpu_torch.ops.topk import GROUP, groupmin, topk_twophase

K = 10
N, D, Q, ITERS, TILE_N = common.N, common.D, 2048, 20, 4096


def candidates(qf, x, xnorms, t_margin: int, select=stable_smallest, k: int = K) -> torch.Tensor:
    """Phase 1: the production group mins of the bf16 query ``qf``, then per
    query the t = min(k + t_margin, ngroups) best groups by ``select`` (a
    stable one: ties to the lowest group id): (Q, t) int32."""
    mins = groupmin(qf, x, xnorms)
    _, cand = select(mins, min(k + t_margin, mins.shape[1]))
    return cand.to(torch.int32).contiguous()


def fused_rescore(q, qf, x, cand, qb: int, k: int = K):
    """Phase 2 fused: every row of the candidate groups scored by
    ``rescore_gather``, then the k best (ties to the earlier selected group,
    then the lower row) as squared distances of the f32 query ``q``.
    Returns (distances (Q, k), ids (Q, k) int64)."""
    vals, ids = common.best_rows(rescore_gather(qf, x, cand, qb=qb), cand, GROUP, k)
    return common.finish_l2(q, vals), ids


def check_store(x, n: int, d: int) -> None:
    if tuple(x.shape) != (n, d):
        raise ValueError(f"built for a ({n}, {d}) store, got {tuple(x.shape)}")


def build(n: int, d: int, tile_n=None, t_margin: int = 2, *, QB: int = 8,
          phase1_only: bool = False):
    """The two-phase search with the fused phase 2 over an (n, d) bf16
    store: fn(q, x, xnorms) -> (distances (Q, k), ids (Q, k)), or with
    ``phase1_only`` (the candidate groups as f32, as int32), both (Q, t).
    ``QB`` is the queries per kernel block (8, 16 or 32). ``tile_n`` was the
    TPU sweep's VMEM tile; nothing on the GPU corresponds to it, so it is
    accepted and ignored."""
    def twophase_fused(q, x, xnorms):
        check_store(x, n, d)
        qf = q.to(torch.bfloat16).contiguous()
        cand = candidates(qf, x, xnorms, t_margin)
        if phase1_only:
            return cand.float(), cand
        return fused_rescore(q, qf, x, cand, QB)

    return twophase_fused


def shipped(q, x, xn):
    return topk_twophase(q, x, K, "l2", x_norms=xn, t_margin=2)


def searches(x, xn):
    """(name, fn(q) -> (distances, ids)): the fused search at margins 2, 3
    and 6, and the production search."""
    n, d = x.shape
    fused = {m: build(n, d, TILE_N, t_margin=m) for m in (2, 3, 6)}
    out = [(f"fused m{m}", lambda q, f=f: f(q, x, xn)) for m, f in fused.items()]
    return out + [("shipped m2", lambda q: shipped(q, x, xn))]


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_bf16_rows()
    qs = common.queries(store, args.iters, args.q)
    fused = dict(searches(x, xn))
    i_ref = fused["shipped m2"](qs[0])[1]
    i_f = fused["fused m2"](qs[0])[1]
    print(f"agreement with shipped phase-2 = "
          f"{common.same_id_sets(i_ref, i_f).double().mean().item():.4f}", flush=True)
    ref = common.float64_topk_ids(qs[0], store.x32, K)
    print(f"recall@10 vs float64: shipped={common.recall(i_ref, ref):.5f} "
          f"fused={common.recall(i_f, ref):.5f}", flush=True)
    for name in ("fused m2", "fused m3"):
        mism = sum(int((~common.same_id_sets(fused["fused m6"](q)[1], fused[name](q)[1])).sum())
                   for q in qs)
        print(f"validation {name} vs fused m6: {mism} / {args.iters * args.q}", flush=True)
    print(common.timed("fused phase-2", fused["fused m2"], qs, ref), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where do the headline dispatch's milliseconds go? The phases of
``topk_twophase`` at the pinned point (1M x 128 bf16, Q = 2048, k = 10,
margin 2, certificate on), each timed as its own call, plus the phase-1
sweep on each query tile it can take.

    python -m image_search_engine_tpu_torch.benchmarks.twophase_breakdown [--qblks 16 32 64 128]
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/twophase_breakdown.py``. It times, in
ms per dispatch (CUDA events over ``--iters`` dispatches, 50 by default):

  1. production phase 1 alone, ``ops.topk.groupmin`` (its :105
     ``phase1_prod``, ``_groupmin_kernel`` on its 1-D grid);
  2. the same sweep on each query tile ``--qblks`` of 16, 32, 64 and 128
     queries, ``ops.groupmin_variants.groupmin_tiled`` (its :126
     ``phase1_2d``: row tiles outer, 256- or 512-query blocks inner), with
     its parity against (1): bit-equal, within the JAX script's rtol = atol
     = 1e-5, or a mismatch. The port's sweep already runs a 2-D grid in the
     TPU variant's order, the query tiles of a slice of groups back to back
     so the slice is read from L2; its tile stops at 128 queries (the
     TPU's 256 and 512 were VMEM blocks). The TPU's 1-D grid held every
     query in one block, which has no counterpart here and is not
     emulated: production takes 128;
  3. phase 1 plus the candidate select (``ops.topk.select_topt``), and
     phase 1 plus ``torch.topk`` over the same (Q, ngroups) mins, the
     library yardstick (``lax.top_k`` was XLA's there);
  4. the full ``topk_twophase(..., t_margin=2, with_certificate=True)``
     with its certified fraction;

and the differences the JAX script prints: the select alone, phase 2 and
the finish. Same data: seed 0, the bf16 store with the norms of its bf16
rows, Q = 2048 bf16 queries drawn after it. Exits 1 if a tile's mins
differ from production's beyond 1e-5.
"""

from __future__ import annotations

import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.groupmin_variants import groupmin_tiled
from image_search_engine_tpu_torch.ops.topk import (MMA_BQ, groupmin, num_groups, select_topt,
                                                    topk_twophase)

N, D, Q, K, MARGIN, DISPATCHES = common.N, common.D, 2048, 10, 2, 50


def parity(mins: torch.Tensor, prod: torch.Tensor) -> str:
    """How a tile's mins compare with production's."""
    if torch.equal(mins, prod):
        return "bit-equal"
    if torch.allclose(mins, prod, rtol=1e-5, atol=1e-5):
        return "OK (within rtol = atol = 1e-5)"
    return "MISMATCH"


def main(argv=None) -> int:
    def qblks(ap):
        ap.add_argument("--qblks", type=int, nargs="*", default=list(MMA_BQ),
                        help=f"query tiles of the sweep to time, of {MMA_BQ}")

    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=DISPATCHES, extra=qblks)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, norms = store.x, store.norms_bf16_rows()
    q = common.queries(store, 1, args.q)[0].to(torch.bfloat16)
    dispatches = [q] * args.iters

    def timeit(name, fn):
        out, _ = common.first_call(fn, q)
        el = max(common.time_dispatches(fn, dispatches), 1e-9) / args.iters
        print(f"{name}: {el * 1e3:.2f} ms/dispatch ({args.q / el / 1e3:.1f}k QPS)", flush=True)
        return out, el

    prod, t_p1 = timeit("phase1 groupmin (production)", lambda q: groupmin(q, x, norms))
    bad = 0
    for bq in args.qblks:
        mins, _ = timeit(f"phase1 groupmin_tiled bq={bq}",
                         lambda q, bq=bq: groupmin_tiled(q, x, norms, bq))
        verdict = parity(mins, prod)
        bad += verdict == "MISMATCH"
        print(f"  parity vs production: {verdict}", flush=True)
    t = min(K + MARGIN, num_groups(args.n))
    _, t_sel = timeit("phase1 + select_topt", lambda q: select_topt(groupmin(q, x, norms), t))
    print(f"  -> select stage alone ~{(t_sel - t_p1) * 1e3:.2f} ms", flush=True)
    _, t_lib = timeit("phase1 + torch.topk (library)",
                      lambda q: torch.topk(groupmin(q, x, norms), t, dim=1, largest=False))
    print(f"  -> torch.topk alone ~{(t_lib - t_p1) * 1e3:.2f} ms", flush=True)
    (_, _, cert), t_full = timeit(
        "full topk_twophase (headline)",
        lambda q: topk_twophase(q, x, K, "l2", x_norms=norms, t_margin=MARGIN,
                                with_certificate=True))
    print(f"  certified: {cert.float().mean().item() * 100:.1f}%", flush=True)
    print(f"  -> phase-2 rescore and finish ~{(t_full - t_sel) * 1e3:.2f} ms", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

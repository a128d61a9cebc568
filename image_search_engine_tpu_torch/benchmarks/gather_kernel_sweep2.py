"""Phase 1 split and attacked: the sweep alone, an approximate select, and
Q = 4096.

    python -m image_search_engine_tpu_torch.benchmarks.gather_kernel_sweep2
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/gather_kernel_sweep2.py``; see
``gather_kernel_proto``. On that script's data (seed 0, 1M x 128 bf16 store
with the norms of the bf16 rows, k = 10, 20 dispatches) it times: the
group-min sweep alone (its mins summed), the sweep and the exact select,
the sweep and the approximate select (recall target 0.95), the fused search
at margin 3 with the approximate select and at margin 2 with the exact one
(Q = 2048), and the exact fused search at Q = 4096. Prints ms per dispatch
(CUDA events) and QPS; each full search's recall@10 against float64 over
its first dispatch; each select's share of those true neighbours inside
its candidate groups. ``--q`` sets the first Q; the last line runs twice
it.

``jax.lax.approx_max_k`` is approximate on a TPU only (elsewhere it lowers
to an exact top-k), so :func:`approx_smallest` ports the TPU's algorithm:
the entries fall into bins, each bin keeps its smallest, and an exact top-t
runs over the bin minima; the bin count follows XLA's rule
(:func:`approx_reduction`).
"""

from __future__ import annotations

import functools
import math
import sys

import torch
import torch.nn.functional as F

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.benchmarks.gather_kernel_proto import (
    K, candidates, check_store, fused_rescore)
from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.ops.topk import GROUP, groupmin

N, D, Q, ITERS, TILE_N = common.N, common.D, 2048, 20, 4096
#: the TPU's lane width: XLA's approximate top-k leaves a row of at most
#: this many entries whole, and makes at least this many bins
TPU_LANES = 128


def approx_reduction(n: int, t: int, recall_target: float) -> int:
    """log2 of the entries per bin of XLA's approximate top-t over rows of
    n entries (``ApproxTopKReductionOutputSize``, operands of rank 2): the
    bins number at least (1 - t) / ln(recall_target) and at least 128, at
    most n; n / bins is rounded down to a power of two, and that power is
    at most ceil(log2(n / 128)). 0 means no reduction: the exact top-t."""
    if not 0.0 < recall_target < 1.0:
        raise ValueError(f"recall_target={recall_target} outside (0, 1)")
    if n <= TPU_LANES:
        return 0
    bins = min(max(int((1.0 - t) / math.log(recall_target)), TPU_LANES), n)
    log2_red = (n // bins).bit_length() - 1  # floor(log2(n / bins))
    return min(log2_red, (-(-n // TPU_LANES) - 1).bit_length())  # <= ceil(log2(n / 128))


def approx_smallest(vals: torch.Tensor, t: int, recall_target: float = 0.95):
    """The TPU's approximate t smallest of each row of ``vals`` (Q, n),
    ascending: (values (Q, t), positions (Q, t) int64).

    With 2^r entries per bin (:func:`approx_reduction`) there are L =
    ceil(n / 2^r) bins, and entries i and i + L*j share bin i mod L: the
    row is folded in L-wide stripes and reduced elementwise across them, as
    the TPU's partial reduction does over its vector lanes. Each bin keeps
    its smallest entry (the lowest position on ties); an exact stable top-t
    over the L bin minima follows. Two of the true t smallest in one bin
    cost one of them: the recall target sets L.
    """
    nq, n = vals.shape
    r = approx_reduction(n, t, recall_target)
    if r == 0:
        return stable_smallest(vals, t)
    bins = -(-n // (1 << r))
    if t > bins:
        raise ValueError(f"t={t} exceeds the {bins} bins of the approximate select")
    folded = F.pad(vals, (0, bins * (1 << r) - n), value=float("inf")).view(nq, 1 << r, bins)
    bin_min, stripe = folded.min(dim=1)  # the first minimum's stripe on ties
    best, pos = stable_smallest(bin_min, t)
    return best, torch.gather(stripe, 1, pos) * bins + pos


def build_variant(n: int, d: int, tile_n, t_margin: int, *, QB: int = 8, select: str = "exact",
                  stop_after: str | None = None, recall_target: float = 0.95):
    """The fused two-phase search over an (n, d) bf16 store, fn(q, x,
    xnorms) -> (distances (Q, k), ids (Q, k)); ``select`` "exact" or
    "approx"; ``stop_after`` None, "sweep" (the sum of the group mins, as
    (1, 1) f32 and int32) or "select" (the candidate groups, (Q, t) f32 and
    int32). ``tile_n`` (the TPU sweep's VMEM tile) is accepted and
    ignored."""
    if select not in ("exact", "approx") or stop_after not in (None, "sweep", "select"):
        raise ValueError(f"select={select!r}, stop_after={stop_after!r}")
    pick = (stable_smallest if select == "exact"
            else functools.partial(approx_smallest, recall_target=recall_target))

    def fn(q, x, xnorms):
        check_store(x, n, d)
        qf = q.to(torch.bfloat16).contiguous()
        if stop_after == "sweep":
            s = groupmin(qf, x, xnorms).sum()[None, None]
            return s, s.to(torch.int32)
        cand = candidates(qf, x, xnorms, t_margin, select=pick)
        if stop_after == "select":
            return cand.float(), cand
        return fused_rescore(q, qf, x, cand, QB)

    return fn


def partials(x, xn):
    """(name, fn(q)) for the sweep alone and the sweep with each select."""
    n, d = x.shape
    out = []
    for name, kw in (("sweep-only", {"stop_after": "sweep"}),
                     ("sweep+select(exact)", {"stop_after": "select"}),
                     ("sweep+select(approx .95)", {"stop_after": "select", "select": "approx"})):
        fn = build_variant(n, d, TILE_N, 2, **kw)
        out.append((name, lambda q, fn=fn: fn(q, x, xn)))
    return out


def searches(x, xn):
    """(name, fn(q) -> (distances, ids)) for the full searches; the exact
    one (the last) is also timed at twice the first Q."""
    n, d = x.shape
    out = []
    for name, m, kw in (("fused m3 approx.95", 3, {"select": "approx"}),
                        ("fused m2 exact (ref)", 2, {})):
        fn = build_variant(n, d, TILE_N, m, **kw)
        out.append((name, lambda q, fn=fn: fn(q, x, xn)))
    return out


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_bf16_rows()
    rng = store.query_rng()

    def make_queries(nq):
        qh = rng.standard_normal((args.iters, nq, D)).astype("float32")
        qs = torch.from_numpy(qh).to(args.device)
        return qs, common.float64_topk_ids(qs[0], store.x32, K)

    qs, ref = make_queries(args.q)
    for name, fn in partials(x, xn):
        line = common.timed(name, fn, qs)
        if name.startswith("sweep+select"):
            cover = common.group_recall(fn(qs[0])[1], ref, GROUP)
            line += f", true top-10 in the candidates={cover:.5f}"
        print(line, flush=True)
    for name, fn in searches(x, xn):
        print(common.timed(name, fn, qs, ref), flush=True)
    qs2, ref2 = make_queries(2 * args.q)
    print(common.timed(f"fused m2 Q={2 * args.q} tile=2048", fn, qs2, ref2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

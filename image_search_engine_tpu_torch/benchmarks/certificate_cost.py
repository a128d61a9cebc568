"""Cost and trip rate of the exactness certificate at the headline point
(1M x 128 bf16, Q = 2048, k = 10, margin 2), on the card's accumulation
order.

    python -m image_search_engine_tpu_torch.benchmarks.certificate_cost
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/certificate_cost.py``. Over every
dispatched query (40,960) at margins 0, 1 and 2 of ``topk_twophase``: the
certificate's trips, and the queries whose ids differ from margin 6's,
split into true mismatches and boundary ties (``common.margin_split``). A
sound certificate never passes a true mismatch; the TPU found 1538, 67
and 0 mismatches at margins 0, 1, 2 and the certificate caught them. Then
ms per dispatch (CUDA events) with the certificate off and on at margin 2,
and its cost in %.

Same data as the JAX script: seed 0, 1M x 128 standard-normal rows stored
as bf16 with the norms of the bf16 rows, 20 dispatches of Q = 2048. Exits
1 if a certified query's ids are not margin 6's but for a tie.
"""

from __future__ import annotations

import sys

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.topk import topk_twophase

N, D, Q, K, ITERS = common.N, common.D, 2048, 10, 20
MARGINS, WIDE, SHIPPED = (0, 1, 2), 6, 2


def search(x, xn, margin: int, cert: bool):
    """fn(q) -> (distances, ids[, certificates]): production's search."""
    return lambda q: topk_twophase(q, x, K, "l2", x_norms=xn, t_margin=margin,
                                   with_certificate=cert)


def trips(x, xn, qs, margins=MARGINS) -> dict:
    """{margin: common.margin_counts} against margin WIDE, certificate on."""
    return {m: common.margin_counts(search(x, xn, m, True), search(x, xn, WIDE, False), qs)
            for m in margins}


def cost(x, xn, qs) -> dict:
    """{certificate on: seconds a dispatch} at the shipped margin."""
    out = {}
    for cert in (False, True):
        fn = search(x, xn, SHIPPED, cert)
        common.first_call(fn, qs[0])
        out[cert] = max(common.time_dispatches(fn, qs), 1e-9) / len(qs)
    return out


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_bf16_rows()
    qs = common.queries(store, args.iters, args.q)
    bad = 0
    for m, c in trips(x, xn, qs).items():
        bad += c["certified_mismatches"]
        print(f"margin {m}: certificate trips {c['trips']} / {c['queries']}, actual mismatches "
              f"vs m{WIDE} {c['mismatches'] + c['ties']} ({c['mismatches']} true, {c['ties']} "
              f"boundary ties), certified true mismatches {c['certified_mismatches']}",
              flush=True)
    el = cost(x, xn, qs)
    for cert, s in el.items():
        print(f"cert={cert}: {s * 1e3:.2f} ms/dispatch, {args.q / s / 1e3:.1f}k QPS", flush=True)
    print(f"certificate cost: {(1 - el[False] / el[True]) * 100:.2f}% of the QPS", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

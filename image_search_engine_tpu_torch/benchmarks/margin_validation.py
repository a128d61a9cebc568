"""Lock the production candidate margin: timing and exactness of
``topk_twophase(t_margin=...)`` on the card's accumulation order.

    python -m image_search_engine_tpu_torch.benchmarks.margin_validation
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/margin_validation.py``, which
validated the margin on the TPU's summation order; the port's bf16 and
int8 group mins come from ``mma.sync`` with another. For each store dtype
(bf16, int8) and margin in {2, 3}: ms per dispatch (CUDA events) and QPS
at Q = 2048, and agreement with the wide-margin truth (bf16: margin 4;
int8: margin 6) over every dispatched query (40,960): true mismatches
apart from boundary ties (``common.margin_split``), with the certificate's
trips and any certified true mismatch beside them. For int8 also the
recall@10 of one dispatch against f32 brute force (a float64 product on
the device): the int8 search is exact over the quantized store, so this
is the quantization's loss against the unquantized rows.

Same data as the JAX script: seed 0, 1M x 128 standard-normal rows; the
bf16 store with the norms of the f32 rows; the int8 store quantized per
row with the norms of its dequantized rows; 20 dispatches of Q = 2048,
k = 10. Exits 1 if a certified query's ids are not the truth's but for a
tie.
"""

from __future__ import annotations

import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.benchmarks.rescore_variants3 import int8_store
from image_search_engine_tpu_torch.ops.topk import topk_twophase

N, D, Q, K, ITERS = common.N, common.D, 2048, 10, 20
MARGINS = {"bf16": (2, 3), "int8": (2, 3)}
WIDE = {"bf16": 4, "int8": 6}  # the truth's margin per store dtype


def stores(store: common.Store) -> dict:
    """{dtype: (store, topk_twophase's keywords)}: the bf16 rows with the f32
    rows' norms, and the int8 codes with their scales and dequantized norms."""
    codes, scales, xn8 = int8_store(store)
    return {"bf16": (store.x, {"x_norms": store.norms_f32_rows()}),
            "int8": (codes, {"x_norms": xn8, "x_scale": scales})}


def search(st: dict, dtype: str, margin: int, cert: bool = False):
    """fn(q) -> (distances, ids[, certificates]): production's search."""
    x, kw = st[dtype]
    return lambda q: topk_twophase(q, x, K, "l2", t_margin=margin, with_certificate=cert, **kw)


def validate(st: dict, qs: torch.Tensor, margins: dict = MARGINS) -> dict:
    """{(dtype, margin): common.margin_counts} of each margin, certificate
    on, against the dtype's WIDE margin over every dispatch of ``qs``."""
    return {(dt, m): common.margin_counts(search(st, dt, m, cert=True), search(st, dt, WIDE[dt]),
                                          qs)
            for dt, ms in margins.items() for m in ms}


def int8_recall(st: dict, q: torch.Tensor, x32: torch.Tensor, margin: int = 2) -> float:
    """recall@10 of the int8 search over ``q`` against float64 brute force
    over the f32 rows."""
    return common.recall(search(st, "int8", margin)(q)[1], common.float64_topk_ids(q, x32, K))


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    st = stores(store)
    qs = common.queries(store, args.iters, args.q)
    for dt, ms in MARGINS.items():
        for m in ms:
            print(common.timed(f"{dt} margin={m}", search(st, dt, m), qs), flush=True)
    bad = 0
    for (dt, m), c in validate(st, qs).items():
        bad += c["certified_mismatches"]
        print(f"validation {dt} margin={m} vs margin={WIDE[dt]}: {c['mismatches']} mismatched "
              f"queries, {c['ties']} boundary ties / {c['queries']}; certificate trips "
              f"{c['trips']}, certified mismatches {c['certified_mismatches']}", flush=True)
    print(f"int8 margin=2 recall@10 vs f32 brute force over {args.q} queries: "
          f"{int8_recall(st, qs[0], store.x32):.5f}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

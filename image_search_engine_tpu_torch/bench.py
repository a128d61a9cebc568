"""Headline benchmark: exact k-NN query throughput over a 1M x 128 store.

    python -m image_search_engine_tpu_torch.bench [--device cuda|cpu] [--n N] [--q Q] [--iters I]

The PyTorch/CUDA twin of the JAX repo's ``bench.py``, on the same data and
search: seed 0, N x D = 1,000,000 x 128 rows of ``standard_normal`` f32
stored as bf16 with store-true norms (the norms of the bf16 rows, so both
phases score the stored values and the result is provably exact over
them), Q = 4096 queries per dispatch, k = 10, and the certified two-phase
search (``ops.topk.topk_twophase``, ``t_margin=2``, certificate on).

It times ITERS dispatches (default 100) with CUDA events after one warm
call, then computes recall@10 over the whole first dispatch against a
float64 oracle on the device, and prints ONE JSON line with ``bench.py``'s
keys: QPS (``value``), ``vs_baseline`` (QPS / 12,500, ``bench.py``'s
per-chip share of its 100k QPS target), ``recall_at_10_vs_float64``,
``exactness_certified_frac``, ``store_dtype``, ``backend`` ("cuda", or
"cpu" with ``--device cpu``: each kernel's plain version at the sizes
passed, never chosen on its own) and ``elapsed_s``. The card's name and
power limit go to stderr.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.topk import topk_twophase

N, D, Q, K, ITERS = common.N, common.D, 4096, 10, 100
T_MARGIN = 2  # bench.py's margin
PER_CHIP_TARGET = 100_000 / 8  # bench.py: 100k QPS on 8 chips


def search(q: torch.Tensor, x: torch.Tensor, xn: torch.Tensor, k: int = K):
    """bench.py's search: (distances, ids, certificates)."""
    return topk_twophase(q, x, k, "l2", x_norms=xn, t_margin=T_MARGIN, with_certificate=True)


def run(store: common.Store, nq: int = Q, iters: int = ITERS, k: int = K) -> dict:
    """Time ``iters`` dispatches of ``nq`` queries over ``store`` after one
    warm call; recall@k of the first dispatch against float64. Returns
    bench.py's JSON object."""
    x, xn = store.x, store.norms_bf16_rows()
    qs = common.queries(store, iters, nq)
    common.first_call(lambda q: search(q, x, xn, k), qs[0])
    elapsed = max(common.time_dispatches(lambda q: search(q, x, xn, k), qs), 1e-9)
    qps = iters * nq / elapsed
    _, ids, cert = search(qs[0], x, xn, k)
    ref = common.float64_topk_ids(qs[0], store.x32, k)
    n = x.shape[0]
    size = "1M" if n == 1_000_000 else str(n)
    return {
        "metric": f"exact_knn_qps_{size}_d{x.shape[1]}_k{k}_single_chip",
        "value": round(qps, 1),
        "unit": "qps",
        "vs_baseline": round(qps / PER_CHIP_TARGET, 3),
        "recall_at_10_vs_float64": common.recall(ids, ref),
        "exactness_certified_frac": float(cert.float().mean().item()),
        "store_dtype": "bfloat16",
        "backend": x.device.type,
        "elapsed_s": round(elapsed, 4),
    }


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    if args.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"bench: {torch.cuda.get_device_name(args.device)} ({card})", file=sys.stderr)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    print(json.dumps(run(store, args.q, args.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

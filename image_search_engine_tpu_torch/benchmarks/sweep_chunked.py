"""Phase-1 sweep with chunked columns: a chunk's product, then its mins.

    python -m image_search_engine_tpu_torch.benchmarks.sweep_chunked
    (small, on the CPU: add --device cpu --n N --q Q --iters I)

Port of the JAX repo's ``benchmarks/sweep_chunked.py``. There, chunking a
4096-row tile's columns (dot 512 columns, min them, next chunk) exposed
matrix-unit / vector-unit overlap to the TPU's scheduler. Here the chunked
kernel (``ops.groupmin_variants.groupmin_chunked``, CUDA) computes each
chunk's (query tile x chunk) scores with register-blocked FMAs into shared
memory and takes their group mins before the next chunk.

Measures the sweep alone (the mins summed, no select or rescore) for the
production ``groupmin`` ("current") and chunks of 512 and 1024, on the JAX
script's data: seed 0, 1M x 128 standard-normal rows stored as bf16 with
the norms of the bf16 rows, Q = 2048, 30 dispatches. Each variant's sum must
equal the current kernel's within the JAX script's bound.
"""

from __future__ import annotations

import sys

import torch

from image_search_engine_tpu_torch.benchmarks import common
from image_search_engine_tpu_torch.ops.groupmin_variants import groupmin_chunked
from image_search_engine_tpu_torch.ops.topk import groupmin

N, D, Q, ITERS, TILE_N = common.N, common.D, 2048, 30, 4096
CHUNKS = (512, 1024)


def sweeps(x, xn):
    """(name, fn(q) -> sum of the group mins) for the current kernel and each chunk."""
    def current(q):
        return groupmin(q.to(torch.bfloat16).contiguous(), x, xn).double().sum()

    out = [("current", current)]
    for chunk in CHUNKS:
        out.append((f"chunk={chunk}", lambda q, c=chunk: groupmin_chunked(
            q.to(torch.bfloat16).contiguous(), x, xn, c).double().sum()))
    return out


def main(argv=None) -> int:
    args = common.parse_args(__doc__, argv, n=N, q=Q, iters=ITERS)
    store = common.make_store(args.n, D, seed=0, device=args.device)
    x, xn = store.x, store.norms_bf16_rows()
    qs = common.queries(store, args.iters, args.q)
    ref = None
    for name, fn in sweeps(x, xn):
        v = float(common.first_call(fn, qs[0])[0])
        if ref is None:
            ref = v
        elif not abs(v - ref) < abs(ref) * 1e-6 + 1.0:
            raise AssertionError(f"{name}: sum of mins {v} differs from the current kernel's {ref}")
        el = max(common.time_dispatches(fn, qs), 1e-9)
        print(f"sweep {name}: {el / args.iters * 1e3:.2f} ms/dispatch "
              f"({args.iters * args.q / el / 1e3:.1f}k QPS-equivalent)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

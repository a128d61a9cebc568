#!/usr/bin/env python3
"""Time the IVF probed scan's kernels over a grid of batch sizes on an NVIDIA GPU.

    python3 probed_scan_sweep.py [--root DIR] [--tables ivfpq,batched,d512]

Tables, as chip_smoke.py phase 3 builds them: ``ivfpq``, the IVF-PQ serving
table (IVFPQIndex nlist 1024, nprobe 4, m 16 over 1M x 2048 clustered rows;
its bf16 reconstruction, 6 x 1272 rows a query); ``batched``, the JAX
package's batched-IVF point (IVFIndex nlist 1024, nprobe 4 over
benchmarks/ivf_batched_1m.py's 1M x 128 data; f32 and bf16 tables); and
``d512``, the same recipe at d = 512 (rows of 1024 and 2048 bytes, between
the other two tables' widths). At each batch size Q of the grid: the
queries' probes (``rank_buckets``), how many distinct buckets they read, the
byte bound of those buckets, and the device time (one CUDA graph replay, L2
flushed before each: ``chip_smoke.graph_ms``) of every kernel
``ops/ivf.probed_scan`` can run, forced: the slot route on the row kernel
and on the tile kernel, the bucket route (``group_order``, then the tile
kernel); their scores bit-equal. With ``--root DIR`` the port
is imported from DIR (another checkout, e.g. ``git archive`` of an earlier
commit, built there) and the one kernel its ``probed_scan`` runs is timed.
One JSON line a reading; exits non-zero without CUDA or when two kernels'
scores differ.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from dataclasses import replace

import chip_smoke as C

PQ_Q = (1, 16, 32, 64, 128, 256, 512, 1024)
BATCHED_Q = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024)
REPS = 10


def kernels(IV, nprobe, nb, cap, d, isz) -> dict:
    """Each kernel of probed_scan as the plan that forces it (None: the
    wrapper's own choice, for a port without ``probed_scan_plan``)."""
    if not hasattr(IV, "probed_scan_plan"):
        return {"own": None}
    tile = IV.probed_scan_plan(2, nprobe, nb, cap, d, isz, route="bucket")
    return {"slot_row": IV.ProbedScanPlan("slot", 0, 1, 0),
            "slot_tile": replace(tile, route="slot"), "bucket_tile": tile}


@contextlib.contextmanager
def forced(IV, plan):
    keep = getattr(IV, "probed_scan_plan", None)
    if plan is not None:
        IV.probed_scan_plan = lambda *a: plan
    try:
        yield
    finally:
        if plan is not None:
            IV.probed_scan_plan = keep


def sweep(table_name, IV, queries, bc, table, norms, nprobe, grid, flush) -> None:
    import torch

    nb, cap, d = table.shape
    isz = table.element_size()
    for nq in grid:
        q = queries[:nq]
        probe = IV.rank_buckets(q, bc, nprobe).to(torch.int32).contiguous()
        qf = q.to(table.dtype).contiguous()
        ub = torch.unique(probe[(probe >= 0) & (probe < nb)]).numel()
        b = C.bound(ub * cap * (d * isz + 4) + nq * d * isz + nq * nprobe * (4 + cap * 4),
                    2 * nq * nprobe * cap * d, C.F32_FLOPS)
        first = None
        for name, plan in kernels(IV, nprobe, nb, cap, d, isz).items():
            with forced(IV, plan):
                got = IV.probed_scan(qf, table, norms, probe)
                if first is None:
                    first = got
                elif not torch.equal(got.view(torch.int32), first.view(torch.int32)):
                    raise AssertionError(f"{table_name} Q={nq}: {name}'s scores differ")
                ms = C.graph_ms(lambda: IV.probed_scan(qf, table, norms, probe), flush, REPS)
            C.log(json.dumps({
                "table": table_name, "nbuckets": nb, "row_bytes": d * isz, "Q": nq,
                "slots": nq * nprobe, "distinct_buckets": ub,
                "slots_per_bucket": nq * nprobe / ub, "kernel": name,
                "plan": None if plan is None else vars(plan), "device_ms": ms,
                "bound_ms": b[0], "bound_by": b[1]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="import the port from this checkout instead")
    ap.add_argument("--tables", default="ivfpq,batched,d512",
                    help="comma-separated: ivfpq, batched, d512 (default: all)")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, args.root)
    import torch

    if not torch.cuda.is_available():
        print("probed_scan_sweep.py: no CUDA device", file=sys.stderr)
        return 1
    from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex
    from image_search_engine_tpu_torch.ops import _kernels
    from image_search_engine_tpu_torch.ops import ivf as IV

    C.log(f"{C.gpu_name_and_power()}; port from {IV.__file__}")
    C.log(f"kernels built in {_kernels.build()[1]:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")  # 128 MB > L2

    tables = args.tables.split(",")
    if "ivfpq" in tables:
        gen = torch.Generator(device="cuda").manual_seed(C.SEED + 3)  # as phase3_scale's
        centres = 2.0 * torch.randn(C.SCALE_CENTRES, C.SCALE_LATENT, device="cuda",
                                    generator=gen)
        proj = torch.randn(C.SCALE_LATENT, C.SCALE_D, device="cuda",
                           generator=gen) / C.SCALE_LATENT ** 0.5
        x = C.latent_rows(C.SCALE_N, centres, proj, gen)
        queries = C.latent_rows(max(PQ_Q), centres, proj, gen)
        t0 = time.perf_counter()
        index = IVFPQIndex("l2", nlist=C.NLIST, nprobe=C.NPROBE, m=C.PQ_M, device="cuda").add(x)
        recon, rnorms = index.recon_table()
        bc = index._device_arrays_pq()[0]
        C.log(f"IVF-PQ table {tuple(recon.shape)} built in {time.perf_counter() - t0:.1f} s")
        sweep("ivfpq_bf16_d2048", IV, queries, bc, recon, rnorms, index._effective_nprobe(),
              PQ_Q, flush)
        del x, index, recon, rnorms, bc
        torch.cuda.empty_cache()
    for name, d in (("batched", C.BATCHED_D), ("d512", 512)):
        if name not in tables:
            continue
        x, qn = C.batched_ivf_data(d)
        queries = torch.as_tensor(qn, device="cuda")
        for dtype in ("f32", "bf16"):
            index = IVFIndex("l2", nlist=C.BATCHED_NLIST, nprobe=C.BATCHED_NPROBE,
                             table_dtype=dtype, device="cuda").add(x)
            bc, _, table, norms = index._device_arrays()
            sweep(f"batched_{dtype}_d{d}", IV, index._prep(queries), bc, table, norms,
                  index._effective_nprobe(), BATCHED_Q, flush)
            del index, bc, table, norms
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the bench twin and the ported benchmark scripts share: the seeded
1M x 128 store of ``bench.py``, a float64 oracle on the device, recall, the
candidate rescore the TPU scripts left to XLA, timing, and the command line.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from image_search_engine_tpu_torch.ops.distances import stable_smallest
from image_search_engine_tpu_torch.utils.device import resolve_device

N, D = 1_000_000, 128  # bench.py's store: 1M rows of 128 dimensions
#: store rows per float64 product of the oracle (bounds its (Q, rows) block)
ORACLE_ROWS = 1 << 15


@dataclass
class Store:
    """``rng = np.random.default_rng(seed)``'s first draw, ``xh =
    standard_normal((n, d))`` f32, as every script makes it: ``x32`` those
    rows on the device, ``x`` their bf16 copy. ``rng_state`` is the
    generator's state after that draw, where each script draws its queries."""

    x32: torch.Tensor
    x: torch.Tensor
    rng_state: dict

    def query_rng(self) -> np.random.Generator:
        rng = np.random.default_rng()
        rng.bit_generator.state = self.rng_state
        return rng

    def norms_f32_rows(self) -> torch.Tensor:
        """Squared norms of the f32 rows (rescore_variants2, subgroup_*)."""
        return (self.x32 * self.x32).sum(1)

    def norms_bf16_rows(self) -> torch.Tensor:
        """Squared norms of the bf16 rows, the store's true norms (bench.py,
        sweep_chunked)."""
        xb = self.x.float()
        return (xb * xb).sum(1)


def make_store(n: int = N, d: int = D, seed: int = 0, device: str | torch.device = "cuda"
               ) -> Store:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((n, d)).astype(np.float32)
    x32 = torch.from_numpy(xh).to(dev)
    return Store(x32=x32, x=x32.to(torch.bfloat16), rng_state=rng.bit_generator.state)


def queries(store: Store, iters: int, nq: int) -> torch.Tensor:
    """(iters, nq, d) f32 queries on the store's device, drawn as the
    scripts draw them after the store."""
    qh = store.query_rng().standard_normal((iters, nq, store.x.shape[1])).astype(np.float32)
    return torch.from_numpy(qh).to(store.x.device)


def float64_topk_ids(q: torch.Tensor, x32: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest rows of ``x32`` to each query by squared l2 in float64
    (both sides widened from f32), on their device, ``ORACLE_ROWS`` store
    rows at a time: (Q, k) int64. An oracle for recall: the order of exact
    float64 ties is not specified."""
    qd = q.double()
    qn = (qd * qd).sum(1, keepdim=True)
    best_d = torch.empty((q.shape[0], 0), dtype=torch.float64, device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.long, device=q.device)
    for s in range(0, x32.shape[0], ORACLE_ROWS):
        xd = x32[s:s + ORACLE_ROWS].double()
        dist = torch.cat([best_d, qn - 2.0 * (qd @ xd.T) + (xd * xd).sum(1)[None, :]], 1)
        ids = torch.cat([best_i, torch.arange(s, s + xd.shape[0], device=q.device)
                         .expand(q.shape[0], -1)], 1)
        best_d, pos = torch.topk(dist, min(k, dist.shape[1]), dim=1, largest=False)
        best_i = torch.gather(ids, 1, pos)
    return best_i


def recall(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Mean over queries of |got ∩ ref| / k (id sets)."""
    k = ref.shape[1]
    hit = (got[:, :, None].to(ref.device) == ref[:, None, :]).any(2).sum(1)
    return float(hit.double().mean().item() / k)


def rescore_blocks(qf: torch.Tensor, x: torch.Tensor, norms: torch.Tensor, blocks: torch.Tensor,
                   width: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scripts' phase 2 (gather and einsum in XLA there, torch here):
    every row of each query's candidate blocks of ``width`` rows (blocks
    (Q, t)), scored norms - 2 q.x in f32 over the store values, rows past N
    +inf; then the k smallest, ties to the lowest candidate position.
    Returns (scores (Q, k), row ids (Q, k) int64)."""
    nq, t = blocks.shape
    rows = (blocks.long()[:, :, None] * width
            + torch.arange(width, device=blocks.device)).reshape(nq, t * width)
    n = x.shape[0]
    safe = rows.clamp(0, n - 1)
    cross = torch.bmm(x[safe].float(), qf.float()[:, :, None])[:, :, 0]
    dist = torch.where(rows < n, norms[safe] - 2.0 * cross, torch.full_like(cross, float("inf")))
    vals, pos = stable_smallest(dist, k)
    return vals, torch.gather(rows, 1, pos)


def finish_l2(q: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Scores to squared distances: + the f32 query's norm, clamped at 0."""
    return torch.clamp(vals + (q.float() * q.float()).sum(1, keepdim=True), min=0.0)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_dispatches(fn: Callable, inputs: Sequence) -> float:
    """Seconds for ``fn`` over every input in turn, on the device's clock:
    CUDA events around the launches on the card (the stream runs them in
    order), the host clock on the CPU. Call ``fn`` once before to warm."""
    dev = inputs[0].device
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    return time.perf_counter() - t0


def first_call(fn: Callable, x: torch.Tensor) -> Tuple[object, float]:
    """(result, seconds) of ``fn(x)`` run to its end: the first call, which
    builds the kernel library if this process has not."""
    t0 = time.perf_counter()
    out = fn(x)
    sync(x.device)
    return out, time.perf_counter() - t0


def parse_args(doc: str, argv, *, n: int, q: int, iters: int) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=doc,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions); never chosen for you")
    ap.add_argument("--n", type=int, default=n, help=f"store rows (default {n:,})")
    ap.add_argument("--q", type=int, default=q, help=f"queries per dispatch (default {q})")
    ap.add_argument("--iters", type=int, default=iters, help=f"timed dispatches (default {iters})")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    return args

"""Scale-out walkthrough: shard every index family over a device mesh.

Twin of the repo's ``examples/scale_out.py`` on the port. On the card it
shards over every CUDA device, and over 8 shards of the one card when there
is a single device (as the JAX script forces 8 virtual CPU devices);
``--device cpu`` gives the 8-shard CPU mesh.

    python -m image_search_engine_tpu_torch.examples.scale_out [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from image_search_engine_tpu_torch.index.flat import FlatIndex
from image_search_engine_tpu_torch.index.ivf import IVFIndex, IVFPQIndex
from image_search_engine_tpu_torch.parallel.ivf import ShardedIVF, ShardedIVFPQ
from image_search_engine_tpu_torch.parallel.mesh import Mesh, make_mesh

SHARDS_ON_ONE_DEVICE = 8


def scale_out_mesh(device: str) -> Mesh:
    """Every CUDA device, or 8 shards of a single device or of the CPU."""
    mesh = make_mesh(None, device)
    if mesh.size == 1:
        mesh = Mesh([mesh.home] * SHARDS_ON_ONE_DEVICE)
    return mesh


def main(argv=None) -> dict:
    """The four steps; returns each step's top-1 ids (and the PQ bytes a row)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)
    mesh = scale_out_mesh(args.device)
    kinds = sorted({str(d) for d in mesh.devices})
    print(f"mesh: {mesh.size} shards on {', '.join(kinds)}")

    rng = np.random.default_rng(0)
    centers = rng.standard_normal((32, 64)).astype(np.float32) * 4
    x = np.concatenate(
        [c + rng.standard_normal((500, 64)).astype(np.float32) for c in centers])
    q = x[:4] + 0.05 * rng.standard_normal((4, 64)).astype(np.float32)
    dev = mesh.home
    out = {}

    # 1) exact flat search, row-sharded: each shard's certified two-phase
    # search, the candidates merged over the mesh, the certificate AND-ed
    flat = FlatIndex("l2", mesh=mesh).add(x)
    d, i = flat.search(q, 5)
    out["flat"] = i[:, 0].tolist()
    print(f"sharded flat:    top-1 ids {out['flat']} (self-match dist "
          f"{d[:, 0].round(3).tolist()})")

    # 2) sharded IVF: per-shard balanced buckets, probed scan, merge
    ivf = IVFIndex(nlist=16, nprobe=4, device=dev).add(x)
    sivf = ShardedIVF.from_components(x, ivf.centroids, nprobe=4, mesh=mesh)
    d, i = sivf.search(q, 5)
    out["ivf"] = i[:, 0].tolist()
    print(f"sharded IVF:     top-1 ids {out['ivf']}")

    # 3) sharded IVF-PQ: the compressed index on the mesh, each shard
    # holding packed byte codes and the codebooks; reshards straight from a
    # codes-only artifact (no raw vectors needed)
    pq = IVFPQIndex(nlist=16, nprobe=8, m=8, device=dev).add(x)
    spq = ShardedIVFPQ.from_index(pq, mesh)
    d, i = spq.search(q, 5)
    out["ivfpq"] = i[:, 0].tolist()
    out["pq_bytes_per_row"] = bytes_per_row = spq.packed_codes[0].shape[-1]
    print(f"sharded IVF-PQ:  top-1 ids {out['ivfpq']} ({bytes_per_row} bytes/row vs "
          f"{x.shape[1] * 4} raw: {x.shape[1] * 4 // bytes_per_row}x compression on the mesh)")

    # 4) ...with the exact refine on the mesh: the index kept its raw rows,
    # so a shortlist size per call has each shard re-score its own ADC
    # top-C; the merge then ranks exact distances (the JAX script builds a
    # second index with rerank=32 from the same rows: the same codes)
    d, i = spq.search(q, 5, rerank=32)
    out["ivfpq_rerank"] = i[:, 0].tolist()
    print(f"sharded IVF-PQ + exact rerank(32): top-1 ids {out['ivfpq_rerank']} "
          f"(distances exact over the store)")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


if __name__ == "__main__":
    main()
